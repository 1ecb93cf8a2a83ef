"""Point-cloud serving on the PyTorch/CUDA port: train briefly, freeze,
drain a ragged queue.  The twin of ``examples/serve_pointcloud.py``; it
runs on ``cuda`` (the hand kernels) unless told otherwise.

A (miniature) QAT-trained PointMLP-Lite is frozen into inference-only
params (BN fused, optional int8 export) and served through the batched
fixed-shape engine.

    PYTHONPATH=src python examples/torch_serve_pointcloud.py \\
        --requests 11 --batch 4 [--int8] [--train-steps 60] [--device cpu]
"""
import argparse

import torch

from repro_torch.api import PipelineSpec, lite_spec
from repro_torch.data import pointclouds
from repro_torch.models import pointmlp as PM
from repro_torch.serve.pointcloud import PointCloudEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=11,
                    help="ragged queue length (any size; engine pads)")
    ap.add_argument("--batch", type=int, default=4,
                    help="fixed dispatch batch of the engine")
    ap.add_argument("--int8", action="store_true",
                    help="serve the int8 deployment instead of fused fp32")
    ap.add_argument("--backend", choices=("cuda", "ref"), default="cuda",
                    help="cuda: the hand kernels (their plain versions "
                         "on the CPU); ref: plain torch")
    ap.add_argument("--train-steps", type=int, default=0,
                    help="miniature-train first (0 = random weights demo)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()

    spec = lite_spec(pointclouds.N_CLASSES)
    if args.train_steps > 0:
        from repro_torch.train.pointmlp import scale_down, train_eval
        spec = PipelineSpec.from_model_config(
            scale_down(spec.to_model_config()))
        params, oa, _ = train_eval(spec.to_model_config(),
                                   steps=args.train_steps, seed=args.seed,
                                   device=args.device)
        print(f"trained {args.train_steps} steps: overall acc {oa:.3f}")
    else:
        params = PM.pointmlp_init(spec.to_model_config(),
                                  torch.Generator().manual_seed(args.seed))
        print("serving random-init weights (pass --train-steps to train)")

    # The serving spec: deployment precision + backend + streaming-batch
    # semantics (shared URS sampler, per-cloud normalization).
    spec = spec.replace(precision="int8" if args.int8 else "fp32",
                        backend=args.backend).serving()
    engine = PointCloudEngine(params, spec, max_batch=args.batch,
                              seed=args.seed, device=args.device)
    print(engine.describe())
    print(f"warmup/compile: {engine.warmup():.2f}s")

    pts, labels = pointclouds.make_batch(args.seed + 1, 0, spec.n_points,
                                         args.requests, args.device)
    pred = engine.predict(pts)
    names = pointclouds.CLASS_NAMES
    for i in range(args.requests):
        print(f"  request {i:2d}: predicted {names[int(pred[i])]:<9} "
              f"(true {names[int(labels[i])]})")
    s = engine.stats
    print(f"{s.requests} requests in {s.batches} fixed-shape batches "
          f"({s.padded} pad lanes) — {s.samples_per_s:.1f} samples/s")


if __name__ == "__main__":
    main()
