"""Pointwise layers over plain parameter dicts (the JAX package's layout).

Matmul weights are ``[d_in, d_out]`` under ``"w"``; a weight may have
been replaced by an int8 export dict ``{"q", "scale"}``, and the apply
functions dispatch on that.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.core.fusion import batchnorm_apply
from repro_torch.core.quant import QuantConfig


def _normal(generator: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=generator,
                       device=generator.device) * std


def _bn_init(channels: int, device) -> Dict[str, torch.Tensor]:
    return {"gamma": torch.ones(channels, device=device),
            "beta": torch.zeros(channels, device=device),
            "mean": torch.zeros(channels, device=device),
            "var": torch.ones(channels, device=device)}


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               bias: bool = True, scale: Optional[float] = None) -> Dict:
    std = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": _normal(generator, (d_in, d_out), std)}
    if bias:
        p["b"] = torch.zeros(d_out, device=generator.device)
    return p


def conv1d_init(generator: torch.Generator, c_in: int, c_out: int,
                bias: bool = True, bn: bool = False) -> Dict:
    """A pointwise conv1d (PointMLP's only kind): weight [c_in, c_out],
    N(0, 1/c_in) like ``repro.models.layers.conv1d_init`` with ksize=1."""
    p = {"w": _normal(generator, (c_in, c_out), 1.0 / math.sqrt(c_in))}
    if bias:
        p["b"] = torch.zeros(c_out, device=generator.device)
    if bn:
        p["bn"] = _bn_init(c_out, generator.device)
    return p


def _matmul(x: torch.Tensor, w, quant: Optional[QuantConfig]
            ) -> torch.Tensor:
    """Dispatch: fp32 matmul, W8 dequantized matmul, or the W8A8 kernel."""
    if isinstance(w, dict):                  # int8 export {"q", "scale"}
        backend = quant.backend if quant is not None else "int8_ref"
        if backend == "int8_cuda":
            from repro_torch.kernels import ops
            lanes = x.shape[0] if quant.per_lane else 1
            return ops.int8_matmul(x, w["q"], w["scale"], a_bits=quant.a_bits,
                                   lanes=lanes)
        # W8 reference path: dequantized weight matmul.
        return x @ (w["q"].to(x.dtype) * w["scale"].to(x.dtype))
    if quant is not None and quant.enabled:
        raise NotImplementedError(
            "fake-quant (QAT) matmuls wait for the training slice of "
            "ROADMAP.md; serve a frozen int8 or fp32 pipeline")
    return x @ w.to(x.dtype)


def dense_apply(p: Dict, x: torch.Tensor,
                quant: Optional[QuantConfig] = None) -> torch.Tensor:
    y = _matmul(x, p["w"], quant)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def conv1d_apply(p: Dict, x: torch.Tensor,
                 quant: Optional[QuantConfig] = None,
                 bn_eps: float = 1e-5) -> torch.Tensor:
    """Pointwise conv: x [..., C_in] -> [..., C_out]; an unfused BN runs
    in inference mode after the conv."""
    w = p["w"]
    if not isinstance(w, dict) and w.ndim != 2:
        raise NotImplementedError("only pointwise (ksize=1) conv1d is ported")
    y = _matmul(x, w, quant)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    if "bn" in p:
        y = batchnorm_apply(y, p["bn"], bn_eps)
    return y
