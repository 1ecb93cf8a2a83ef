"""Optimizers as ``(init, update)`` pairs over param trees, and the paper's schedule.

The port of ``repro.train.optimizer``.  HLS4PC §3 trains PointMLP with
SGD, momentum 0.8, weight decay 2e-4 and a cosine LR from 0.1 to 0.005;
AdamW is the LM default.  Slots are f32 whatever the param dtype.
Updates are functional: they return new trees and leave their inputs
alone.  Each scalar is formed as JAX forms it (a Python constant times
an f32 tensor, quotients as true divisions), so one update of the two
packages rounds alike.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.sharding import collectives as C
from repro_torch.tree import tree_leaves, tree_map


def cosine_lr(step, cfg: TrainConfig) -> torch.Tensor:
    """0-dim f32 CPU tensor: ``lr_min + (lr - lr_min) (1 + cos(pi t)) / 2``
    with ``t = min(step / steps, 1)``."""
    s = torch.as_tensor(step).to(device="cpu", dtype=torch.float32)
    t = torch.clamp(s / torch.tensor(float(max(cfg.steps, 1))), max=1.0)
    return cfg.lr_min + 0.5 * (cfg.lr - cfg.lr_min) * (
        1.0 + torch.cos(math.pi * t))


def _f32_zeros_like(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


# --------------------------------------------------------------- SGD ----

def sgd_init(params) -> Dict[str, Any]:
    return {"momentum": _f32_zeros_like(params)}


def sgd_update(grads, state, params, lr, cfg: TrainConfig
               ) -> Tuple[Any, Dict[str, Any]]:
    """Heavy-ball SGD with L2 weight decay folded into the gradient."""
    def upd(g, m, p):
        g = g.float() + cfg.weight_decay * p.float()
        m = cfg.momentum * m + g
        return (p.float() - lr * m).to(p.dtype), m

    new = tree_map(upd, grads, state["momentum"], params)
    return (tree_map(lambda g, t: t[0], grads, new),
            {"momentum": tree_map(lambda g, t: t[1], grads, new)})


# ------------------------------------------------------------- AdamW ----

def adamw_init(params) -> Dict[str, Any]:
    return {"m": _f32_zeros_like(params), "v": _f32_zeros_like(params),
            "count": torch.zeros((), dtype=torch.int32)}


def adamw_update(grads, state, params, lr, cfg: TrainConfig,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8
                 ) -> Tuple[Any, Dict[str, Any]]:
    """AdamW with bias correction and decoupled weight decay."""
    count = state["count"] + 1
    c = count.float()
    corr1 = 1.0 - torch.pow(torch.tensor(b1), c)
    corr2 = 1.0 - torch.pow(torch.tensor(b2), c)

    def upd(g, m, v, p):
        g = g.float()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        step = (m / corr1.to(m.device)) / (
            torch.sqrt(v / corr2.to(v.device)) + eps)
        p32 = p.float()
        p32 = p32 - lr * (step + cfg.weight_decay * p32)
        return p32.to(p.dtype), m, v

    new = tree_map(upd, grads, state["m"], state["v"], params)

    def part(i):
        return tree_map(lambda g, t: t[i], grads, new)
    return part(0), {"m": part(1), "v": part(2), "count": count}


def get_optimizer(cfg: TrainConfig):
    if cfg.optimizer == "sgd":
        return sgd_init, sgd_update
    if cfg.optimizer == "adamw":
        return adamw_init, adamw_update
    raise ValueError(cfg.optimizer)


def global_norm(tree, placement=None) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every leaf, in f32, the leaves' sums
    added in tree order.  With a ``sharding.rules.Placement`` whose
    shardings split leaves (each rank holding its block), a split leaf's
    sum is summed over the ranks that split it (one all-reduce for each
    set of mesh axes) and a leaf whole on every rank is counted once, so
    every rank gets the whole tree's norm."""
    sums = [(x.float() ** 2).sum() for x in tree_leaves(tree)]
    shardings = None if placement is None else placement.params
    if shardings is not None:
        by_axes = {}
        for i, sh in enumerate(tree_leaves(shardings)):
            axes = placement.sharded_axes(sh)
            if axes:
                by_axes.setdefault(axes, []).append(i)
        for axes, idx in sorted(by_axes.items()):
            part = torch.stack([sums[i] for i in idx])
            C.all_reduce_(part, C.process_group(placement.mesh, axes))
            for j, i in enumerate(idx):
                sums[i] = part[j]
    total = 0
    for s in sums:
        total = total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float, placement=None):
    """(grads scaled by ``min(1, max_norm / (norm + 1e-9))``, norm); the
    norm as :func:`global_norm` takes it under ``placement``."""
    norm = global_norm(grads, placement)
    # a true division: ``float / tensor`` multiplies by a reciprocal
    scale = torch.clamp(norm.new_tensor(max_norm) / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm
