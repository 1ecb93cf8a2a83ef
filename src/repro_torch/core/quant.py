"""Quantization: QAT fake-quant (STE), symmetric absmax scales and the int8 export (HLS4PC §2.2).

The port of ``repro.core.quant``: scales, rounding and the int8 export
consumed by ``repro_torch.kernels.int8_matmul``, and the training half,
fake-quant with the straight-through estimator.  Export dicts keep the
JAX layout, ``{"q": int8[..., d_in, d_out], "scale": f32[..., 1,
d_out]}``.  ``torch.round`` rounds half to even, as ``jnp.round`` does,
so the exports are bit-identical.

Fake-quant is ``x + (q - x).detach()`` with the scale detached, the
expression ``repro.core.quant.fake_quant`` writes with
``stop_gradient``: the forward value rounds as JAX's does and the
gradient is the identity.  The QAT activation scale is one absmax over
the whole tensor (the batch included), unlike serving's per-lane scale.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.tree import tree_map_with_path


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Quantization parametrization of one layer.

    ``backend`` names the matmul of an int8 export dict: ``int8_ref``
    (dequantized-weight matmul, W8) or ``int8_cuda`` (W8A8 through the
    int8 kernel, the port's counterpart of ``int8_pallas``); JAX's
    default ``fake`` is accepted too and means ``int8_ref`` there.  A
    float weight under an enabled config is fake-quantized whatever the
    backend (QAT), as in ``repro.models.layers._matmul``.  ``per_lane``
    quantizes activations with one absmax scale per batch lane instead
    of one per tensor: under serving semantics the JAX walk maps over
    lanes, so its per-tensor scale is a per-lane scale of the port's
    batched dispatch.  ``tiles`` (``int8_cuda`` only) pins the int8
    kernel's template: a ``KernelTuning.int8_matmul`` value, or None for
    the wrapper's rule (as ``repro.core.quant.QuantConfig.tiles``
    carries the Pallas tiles).
    """
    w_bits: int = 8
    a_bits: int = 8
    per_channel: bool = True
    symmetric: bool = True
    backend: str = "int8_ref"
    per_lane: bool = False
    tiles: Optional[Tuple[int, int, int]] = None

    @property
    def enabled(self) -> bool:
        return self.w_bits < 32 or self.a_bits < 32


def qrange(bits: int) -> Tuple[int, int]:
    return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1


def _div_qmax(amax: torch.Tensor, qmax: int) -> torch.Tensor:
    """``amax / qmax`` as a true division on every device (PyTorch's CUDA
    division by a Python scalar multiplies by a rounded reciprocal)."""
    return amax / amax.new_full((), float(qmax))


def compute_scale(x: torch.Tensor, bits: int, axis: Optional[int] = None
                  ) -> torch.Tensor:
    """Symmetric absmax scale. ``axis`` keeps that axis (per-channel).

    As in ``repro.core.quant``, ``axis`` is compared with the
    non-negative dim numbers, so a negative ``axis`` keeps no axis.
    """
    qmax = 2 ** (bits - 1) - 1
    if axis is None:
        amax = x.abs().amax()
    else:
        red = tuple(i for i in range(x.ndim) if i != axis)
        amax = x.abs().amax(dim=red, keepdim=True)
    return _div_qmax(amax.clamp_min(1e-8), qmax)


def quantize(x: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    qmin, qmax = qrange(bits)
    return torch.clamp(torch.round(x / scale), qmin, qmax)


def _round_ste(x: torch.Tensor, scale: torch.Tensor, bits: int
               ) -> torch.Tensor:
    """``x`` rounded to the grid of ``scale`` in the forward, the
    identity in the backward (the scale gets no gradient)."""
    scale = scale.detach()
    q = quantize(x, scale, bits) * scale
    return x + (q - x).detach()


def fake_quant(x: torch.Tensor, bits: int, axis: Optional[int] = None
               ) -> torch.Tensor:
    """Quantize-dequantize with a straight-through estimator: the
    forward rounds to the absmax grid (``axis`` keeps that axis), the
    gradient is the identity."""
    if bits >= 32:
        return x
    return _round_ste(x, compute_scale(x, bits, axis), bits)


def weight_scale(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-out-channel scale of a weight ``[..., d_in, d_out]``: reduce
    only the contraction dim, so stacked layers keep their own scales."""
    qmax = 2 ** (bits - 1) - 1
    return _div_qmax(w.abs().amax(dim=-2, keepdim=True).clamp_min(1e-8), qmax)


def fake_quant_weight(w: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Weights are ``[..., d_in, d_out]``; per-channel over the out axis."""
    if cfg.w_bits >= 32:
        return w
    if not cfg.per_channel:
        return fake_quant(w, cfg.w_bits, None)
    return _round_ste(w, weight_scale(w, cfg.w_bits), cfg.w_bits)


def fake_quant_act(x: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Activations: one scale over the whole tensor."""
    return fake_quant(x, cfg.a_bits, axis=None)


def quantize_weight_int8(w: torch.Tensor, cfg: QuantConfig
                         ) -> Dict[str, torch.Tensor]:
    """Export one weight to ``{q: int8[...], scale: f32[..., 1, d_out]}``."""
    if cfg.w_bits > 8:
        raise ValueError(f"int8 export needs w_bits <= 8, got {cfg.w_bits}")
    if cfg.per_channel and w.ndim >= 2:
        scale = weight_scale(w, cfg.w_bits)
    else:
        scale = compute_scale(w, cfg.w_bits, None)
    q = quantize(w, scale, cfg.w_bits).to(torch.int8)
    return {"q": q, "scale": scale.to(torch.float32)}


def is_quantizable_leaf_path(path: tuple) -> bool:
    """Quantize matmul weights only (named ``w`` / ``kernel`` / ``*_w``),
    never norms, biases or embeddings.  ``path`` holds plain dict keys
    and list indices."""
    last = str(path[-1])
    return last == "w" or last == "kernel" or last.endswith("_w")


def quantize_tree(params: Any, cfg: QuantConfig,
                  predicate: Optional[Callable[[tuple, Any], bool]] = None
                  ) -> Any:
    """Replace each quantizable weight leaf with its int8 export dict.

    ``predicate(path, leaf)`` selects the leaves (default: a matmul
    weight name and ``ndim >= 2``); everything else passes through.
    The leaves of an existing export dict (``q``, ``scale``) never
    match, so an already-frozen tree passes through unchanged.
    """
    def fix(path, leaf):
        take = (predicate(path, leaf) if predicate is not None
                else is_quantizable_leaf_path(path)
                and getattr(leaf, "ndim", 0) >= 2)
        return quantize_weight_int8(leaf, cfg) if take else leaf
    return tree_map_with_path(fix, params)


def dequantize_tree(qparams: Any) -> Any:
    """Inverse of :func:`quantize_tree`: every ``{"q", "scale"}`` dict
    becomes ``f32(q) * scale``."""
    if isinstance(qparams, dict):
        if set(qparams) == {"q", "scale"}:
            return qparams["q"].to(torch.float32) * qparams["scale"]
        return {k: dequantize_tree(v) for k, v in qparams.items()}
    if isinstance(qparams, (list, tuple)):
        return type(qparams)(dequantize_tree(v) for v in qparams)
    return qparams


def stochastic_round_int8(x: torch.Tensor, scale: torch.Tensor,
                          rand_bits: torch.Tensor) -> torch.Tensor:
    """Stochastic rounding of ``x / scale`` to int8, driven by
    ``rand_bits``: uint32 uniform bits (any integer dtype holding values
    below 2**32), the shape of ``x``.  A value rounds up when its
    ``u = (bits + 0.5) / 2**32`` (in f32) is below its fraction."""
    y = x / scale
    fl = torch.floor(y)
    frac = y - fl
    # dividing by a power of two is exact on every device
    u = ((rand_bits.to(torch.int64) & 0xFFFFFFFF).to(torch.float32)
         + 0.5) / 4294967296.0
    q = fl + (u < frac).to(y.dtype)
    return torch.clamp(q, -128, 127).to(torch.int8)


def tree_size_bytes(params: Any) -> int:
    """Model size in bytes over every tensor leaf."""
    total = 0

    def add(_path, leaf):
        nonlocal total
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        return leaf
    tree_map_with_path(add, params)
    return total
