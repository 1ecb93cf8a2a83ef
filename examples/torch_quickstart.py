"""Quickstart on the PyTorch/CUDA port: train a small PointMLP-Lite on the
synthetic point-cloud set, compress it (BN fusion + int8 export), and
classify.  The twin of ``examples/quickstart.py``; it runs on ``cuda``
unless told otherwise.

    PYTHONPATH=src python examples/torch_quickstart.py [--steps 150] \\
        [--device cpu]
"""
import argparse

import torch

from repro_torch.core import compress as CP
from repro_torch.core import sampling
from repro_torch.data import pointclouds
from repro_torch.models import pointmlp as PM
from repro_torch.train.pointmlp import scale_down, train_eval


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()

    cfg = scale_down(PM.pointmlp_lite_config())
    print(f"config: {cfg.name}  points={cfg.n_points} "
          f"sampler={cfg.sampler} quant={cfg.quant.w_bits}/"
          f"{cfg.quant.a_bits}")
    params, oa, ma = train_eval(cfg, steps=args.steps, device=args.device)
    print(f"trained {args.steps} steps: OA={oa:.3f}  mA={ma:.3f}")

    deploy, dcfg, report = CP.compress(params, cfg)
    print(f"compressed: {report.bn_blocks_fused} BN blocks fused, "
          f"{report.size_ratio_vs_f32:.1f}x smaller than fp32")

    pts, cls = pointclouds.make_batch(99, 0, cfg.n_points, 8, args.device)
    lfsr = sampling.seed_streams(7, 64)
    logits, _, _ = PM.pointmlp_apply(deploy, dcfg, pts, lfsr)
    pred = torch.argmax(logits, -1)
    names = pointclouds.CLASS_NAMES
    for i in range(8):
        print(f"  sample {i}: predicted={names[int(pred[i])]:9s} "
              f"true={names[int(cls[i])]}")


if __name__ == "__main__":
    main()
