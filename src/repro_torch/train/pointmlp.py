"""Miniature PointMLP training on the synthetic set: the port of ``benchmarks/_pointmlp_train.py``.

ModelNet40 does not ship with the repository, so the 8-class synthetic
set of :mod:`repro_torch.data.pointclouds` stands in, and configs are
scaled down (:func:`scale_down`) so a ladder rung trains in minutes.
A step is the JAX harness's: the loss of ``pointmlp_apply(...,
train=True)``, ``torch.autograd.grad`` over every param leaf, plain SGD
at a cosine-annealed rate, then the BN entries taken from the forward's
refreshed tree (:func:`merge_bn`; note that this keeps each BN's gamma
and beta as they were, as the JAX harness does).  Everything runs on
``device``: ``cuda`` unless the caller asks for the CPU.  The initial
params are drawn on the CPU from ``seed`` and moved, so every device
starts from the same bits.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.api.build import resolve_device, to_device
from repro_torch.core import sampling
from repro_torch.data import pointclouds
from repro_torch.models import pointmlp as PM
from repro_torch.models.layers import softmax_cross_entropy
from repro_torch.train.train_loop import value_and_grad
from repro_torch.tree import tree_map


def scale_down(cfg: PM.PointMLPConfig) -> PM.PointMLPConfig:
    return cfg.replace(n_classes=pointclouds.N_CLASSES,
                       n_points=max(64, cfg.n_points // 4),
                       embed_dim=16, k_neighbors=8)


def loss_and_grads(params: Dict, cfg: PM.PointMLPConfig, pts: torch.Tensor,
                   cls: torch.Tensor, lfsr: torch.Tensor):
    """(loss, grads, params with refreshed BN stats, advanced LFSR
    state) of one training forward on a batch."""
    def loss_fn(p, batch):
        logits, p_new, lf = PM.pointmlp_apply(p, cfg, batch["pts"],
                                              batch["lfsr"], train=True)
        return softmax_cross_entropy(logits, batch["cls"]), (p_new, lf)

    (loss, (p_new, lf)), grads = value_and_grad(
        loss_fn, params, {"pts": pts, "cls": cls, "lfsr": lfsr})
    return loss, grads, p_new, lf


def sgd_step(params: Dict, cfg: PM.PointMLPConfig, pts: torch.Tensor,
             cls: torch.Tensor, lfsr: torch.Tensor, lr):
    """One step of the harness: (loss, new params, LFSR state)."""
    loss, grads, p_new, lf = loss_and_grads(params, cfg, pts, cls, lfsr)
    p2 = tree_map(lambda a, b: a - lr * b, params, grads)
    return loss, merge_bn(p2, p_new), lf


def cosine(lr: float, s: int, steps: int) -> torch.Tensor:
    """The harness's schedule, ``lr (1 + cos(pi s / steps)) / 2``, in f32
    as JAX forms it (a 0-dim CPU tensor)."""
    c = torch.cos(torch.tensor(math.pi * s / steps, dtype=torch.float32))
    return lr * (0.5 * (1 + c))


def train_eval(cfg: PM.PointMLPConfig, steps: int = 150, batch: int = 16,
               lr: float = 0.02, seed: int = 0,
               init_params: Optional[Dict] = None, device=None
               ) -> Tuple[Dict, float, float]:
    """Train ``steps`` on the synthetic set; return (params, overall
    accuracy, mean class accuracy) on :func:`evaluate`'s held-out set."""
    dev = resolve_device(device)
    params = to_device(init_params if init_params is not None else
                       PM.pointmlp_init(cfg, torch.Generator()
                                        .manual_seed(seed)), dev)
    lfsr = sampling.seed_streams(seed, max(batch, 64))
    for s in range(steps):
        pts, cls = pointclouds.make_batch(seed, s, cfg.n_points, batch, dev)
        _, params, lfsr = sgd_step(params, cfg, pts, cls, lfsr,
                                   cosine(lr, s, steps))
    oa, ma = evaluate(params, cfg, seed, device=dev)
    return params, oa, ma


def evaluate(params: Dict, cfg: PM.PointMLPConfig, seed: int = 0,
             n_batches: int = 8, batch: int = 32, device=None
             ) -> Tuple[float, float]:
    """(overall accuracy, mean class accuracy) of eval-mode forwards on
    ``pointclouds.eval_set(seed, ...)``."""
    dev = resolve_device(device)
    lfsr = sampling.seed_streams(seed + 1, max(batch, 64))
    hit = torch.zeros(pointclouds.N_CLASSES, dtype=torch.float64)
    tot = torch.zeros(pointclouds.N_CLASSES, dtype=torch.float64)
    for pts, cls in pointclouds.eval_set(seed, cfg.n_points, n_batches,
                                         batch, dev):
        logits, _, lfsr = PM.pointmlp_apply(params, cfg, pts, lfsr)
        ok = (logits.argmax(-1) == cls).double().cpu()
        hit.index_add_(0, cls.cpu(), ok)
        tot.index_add_(0, cls.cpu(), torch.ones_like(ok))
    oa = float(hit.sum()) / (n_batches * batch)
    ma = float((hit / tot.clamp_min(1)).mean())
    return oa, ma


def merge_bn(p_sgd, p_stats):
    """``p_sgd`` with every ``bn`` entry taken from ``p_stats`` (the
    forward's refreshed running stats), as ``_merge_bn`` does."""
    if isinstance(p_sgd, dict):
        return {k: (p_stats[k] if k == "bn" else merge_bn(v, p_stats[k]))
                for k, v in p_sgd.items()}
    if isinstance(p_sgd, list):
        return [merge_bn(a, b) for a, b in zip(p_sgd, p_stats)]
    return p_sgd
