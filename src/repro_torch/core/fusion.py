"""Batch-norm folded into the preceding pointwise conv / linear (HLS4PC §2.2).

    y = gamma * (w x + b - mu) / sqrt(var + eps) + beta
      = (w * g) x + ((b - mu) * g + beta),   g = gamma / sqrt(var + eps)

The same exact algebra as ``repro.core.fusion``; the fused parameters
are what the int8 export consumes.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch


def batchnorm_apply(x: torch.Tensor, bn: Dict[str, torch.Tensor],
                    eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode BN over the last (channel) axis."""
    inv = torch.rsqrt(bn["var"] + eps)
    return (x - bn["mean"]) * inv * bn["gamma"] + bn["beta"]


def fuse_conv_bn(w: torch.Tensor, b: torch.Tensor,
                 bn: Dict[str, torch.Tensor], eps: float = 1e-5
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold BN into a weight ``[..., C_out]`` and bias: ``w' x + b' ==
    BN(w x + b)``."""
    g = bn["gamma"] * torch.rsqrt(bn["var"] + eps)
    return w * g, (b - bn["mean"]) * g + bn["beta"]


def fuse_tree(params: Any, eps: float = 1e-5) -> Any:
    """Fuse every ``{"w", "b", "bn"}`` block of a param tree; the result
    drops the ``bn`` entries."""
    if isinstance(params, dict):
        if {"w", "b", "bn"} <= set(params):
            w_f, b_f = fuse_conv_bn(params["w"], params["b"], params["bn"],
                                    eps)
            rest = {k: fuse_tree(v, eps) for k, v in params.items()
                    if k not in ("w", "b", "bn")}
            return {"w": w_f, "b": b_f, **rest}
        return {k: fuse_tree(v, eps) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(fuse_tree(v, eps) for v in params)
    return params


def fuse_pointmlp(params: Any, cfg: Any, eps: float = 1e-5
                  ) -> Tuple[Any, Any]:
    """Whole-tree inference freeze: (fused params, ``cfg`` with
    ``use_bn=False``)."""
    return fuse_tree(params, eps), cfg.replace(use_bn=False)


def count_bn_blocks(params: Any) -> int:
    """The number of ``{"w", "b", "bn"}`` blocks in a param tree (what
    :func:`fuse_tree` folds)."""
    n = 0
    if isinstance(params, dict):
        if {"w", "b", "bn"} <= set(params):
            n += 1
        for v in params.values():
            n += count_bn_blocks(v) if isinstance(v, (dict, list, tuple)) else 0
    elif isinstance(params, (list, tuple)):
        n += sum(count_bn_blocks(v) for v in params)
    return n
