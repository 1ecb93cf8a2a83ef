#!/usr/bin/env python3
"""How far one float32 training step moves when only its summation order changes.

Runs one training step (loss, gradients, refreshed BN stats) of
full-width PointMLP-Lite (8/8 fake quant, batch 8) and PointMLP-Elite
(fp32, batch 4) twice on the CPU from the same params, batch and LFSR
state: once as the port runs it, once with every product accumulated in
float64 and rounded once to float32, a change of rounding like the one
between cuBLAS on the card and MKL on the CPU.  It prints, a model a
line, how many fake-quant activation codes differ, the loss's relative
change, the gradient tree's and the worst leaf's relative change in
norm, and the worst BN running stat's change over its leaf's largest
value.  ``chip_smoke.py``'s ``train`` phase sets its card-against-CPU
tolerances from these numbers.

    PYTHONPATH=src python3 scripts/train_rounding.py [--seed 0]
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.core import quant as Q
from repro_torch.core import sampling
from repro_torch.data import pointclouds
from repro_torch.models import layers as L
from repro_torch.models import pointmlp as PM
from repro_torch.train import pointmlp as TP
from repro_torch.tree import leaves_with_paths


def one_step(cfg, params, pts, cls, f64_products: bool):
    """(loss, {path: grad}, {path: refreshed leaf}, activation codes)."""
    codes = []
    act, mm = L.fake_quant_act, L.matmul

    def tap(x, q):
        codes.append(torch.round(x.detach() / Q.compute_scale(
            x.detach(), q.a_bits)).clamp(-128, 127))
        return act(x, q)
    L.fake_quant_act = tap
    if f64_products:
        L.matmul = lambda x, w: (x.double() @ w.double()).float()
    try:
        loss, grads, p_new, _ = TP.loss_and_grads(
            params, cfg, pts, cls, sampling.seed_streams(0, pts.shape[0]))
    finally:
        L.fake_quant_act, L.matmul = act, mm
    return (float(loss), dict(leaves_with_paths(grads)),
            dict(leaves_with_paths(p_new)), codes)


def compare(name, cfg, batch, seed):
    params = PM.pointmlp_init(cfg, torch.Generator().manual_seed(seed))
    pts, cls = pointclouds.make_batch(seed, 0, cfg.n_points, batch, "cpu")
    a = one_step(cfg, params, pts, cls, False)
    b = one_step(cfg, params, pts, cls, True)
    ga, gb = a[1], b[1]
    norm = sum(float((v.double() ** 2).sum()) for v in ga.values()) ** 0.5
    tree = sum(float(((ga[k] - gb[k]).double() ** 2).sum())
               for k in ga) ** 0.5 / norm
    leaf = max(float((ga[k] - gb[k]).norm()) / (float(ga[k].norm())
                                                + 1e-4 * norm)
               for k in ga)
    bn = max(float((a[2][k] - b[2][k]).abs().max())
             / (float(a[2][k].abs().max()) + 1e-6)
             for k in a[2] if k[-1] in ("mean", "var"))
    return {"model": name, "batch": batch,
            "codes_differ": sum(int((x != y).sum())
                                for x, y in zip(a[3], b[3])),
            "codes": sum(int(x.numel()) for x in a[3]),
            "loss_rel": abs(a[0] - b[0]) / abs(a[0]),
            "grad_tree_rel": tree, "grad_leaf_rel_max": leaf,
            "bn_rel_max": bn}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    print(json.dumps(compare("lite", PM.pointmlp_lite_config(40), 8,
                             args.seed)))
    print(json.dumps(compare("elite", PM.pointmlp_elite_config(40), 4,
                             args.seed)))


if __name__ == "__main__":
    main()
