"""Batch-norm folded into the preceding pointwise conv / linear (HLS4PC §2.2).

    y = gamma * (w x + b - mu) / sqrt(var + eps) + beta
      = (w * g) x + ((b - mu) * g + beta),   g = gamma / sqrt(var + eps)

The same exact algebra as ``repro.core.fusion``; the fused parameters
are what the int8 export consumes.

Training-mode BN (:func:`batch_moments`, :func:`batchnorm_update_stats`)
follows the JAX package, not ``torch.nn.BatchNorm``: the batch variance
is the population one (divided by the count, not by count - 1), and the
running stats move as ``m * old + (1 - m) * new`` with ``m`` the config's
``bn_momentum`` (0.9), where torch's ``momentum`` weighs the new value.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch


def batchnorm_init(channels: int, device=None) -> Dict[str, torch.Tensor]:
    """Identity BN: gamma 1, beta 0, running mean 0, running var 1."""
    return {"gamma": torch.ones(channels, device=device),
            "beta": torch.zeros(channels, device=device),
            "mean": torch.zeros(channels, device=device),
            "var": torch.ones(channels, device=device)}


def batch_moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and population variance of ``x [..., C]`` over every axis but
    the last (``jnp.mean`` and ``jnp.var`` over those axes)."""
    red = tuple(range(x.ndim - 1))
    mu = x.mean(dim=red)
    return mu, ((x - mu) ** 2).mean(dim=red)


def running_stats(bn: Dict[str, torch.Tensor], mu: torch.Tensor,
                  var: torch.Tensor, momentum: float
                  ) -> Dict[str, torch.Tensor]:
    """``bn`` with its running stats moved toward the batch's:
    ``momentum * old + (1 - momentum) * new``."""
    return {"gamma": bn["gamma"], "beta": bn["beta"],
            "mean": momentum * bn["mean"] + (1 - momentum) * mu,
            "var": momentum * bn["var"] + (1 - momentum) * var}


def batchnorm_update_stats(bn: Dict[str, torch.Tensor], x: torch.Tensor,
                           momentum: float = 0.9) -> Dict[str, torch.Tensor]:
    """EMA running-stat update (training mode) from ``x [..., C]``."""
    mu, var = batch_moments(x)
    return running_stats(bn, mu, var, momentum)


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
