"""Public wrappers of the CUDA kernels, on tensors of any leading shape.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version (``repro_torch.kernels.ref``) for CPU tensors; it never falls
back from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import compute_scale, qrange
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.fused_linear import fused_linear_cuda
from repro_torch.kernels.int8_matmul import int8_matmul_cuda, w8_matmul_cuda


def _device_kind(*ts: torch.Tensor) -> str:
    kinds = {t.device.type for t in ts}
    if len(kinds) != 1 or not kinds <= {"cuda", "cpu"}:
        raise ValueError(f"tensors must all lie on one CUDA device or all "
                         f"on the CPU, got {sorted(kinds)}")
    return kinds.pop()


def quantize_activations(x: torch.Tensor, a_bits: int, lanes: int = 1):
    """Symmetric absmax quantization with one scale per lane.

    x [L * r, ..., K] -> (x_q int8 [M, K], a_scale f32 [lanes]); the
    arithmetic of ``repro.core.quant.compute_scale`` then ``quantize``,
    applied to each lane's slice (``lanes=1`` is one per-tensor scale).
    The int8 cast saturates, as XLA's ``astype(jnp.int8)`` does: past
    ``a_bits = 8`` the grid is wider than int8, and ``Tensor.to(int8)``
    would wrap (CPU) or is undefined (CUDA) there.
    """
    qmin, qmax = qrange(a_bits)
    flat = x.reshape(lanes, -1)
    a_scale = compute_scale(flat, a_bits, axis=0).reshape(lanes)
    x_q = torch.clamp(torch.round(flat / a_scale[:, None]), max(qmin, -128),
                      min(qmax, 127))
    return x_q.to(torch.int8).reshape(-1, x.shape[-1]), a_scale


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                a_bits: int = 8, lanes: int = 1) -> torch.Tensor:
    """W8A8: quantize activations on the fly, then the int8 kernel.

    x f32 [..., K], w_q int8 [K, N], w_scale f32 [1, N] -> f32 [..., N].
    ``lanes`` splits the leading dim into that many clouds, each with its
    own activation scale.
    """
    kind = _device_kind(x, w_q, w_scale)
    x_q, a_scale = quantize_activations(x, a_bits, lanes)
    rows_per_lane = x_q.shape[0] // lanes
    w_scale = w_scale.reshape(-1)
    if kind == "cuda":
        y = int8_matmul_cuda(x_q, w_q.contiguous(), a_scale.contiguous(),
                             w_scale.contiguous(), rows_per_lane)
    else:
        y = ref.int8_matmul_ref(x_q, w_q, a_scale, w_scale, rows_per_lane)
    return y.reshape(*x.shape[:-1], w_q.shape[1])


def fused_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 activation: str = "relu") -> torch.Tensor:
    """act(x @ w + b) over x [..., K] -> [..., N]."""
    kind = _device_kind(x, w, b)
    x2 = x.reshape(-1, x.shape[-1])
    if kind == "cuda":
        y = fused_linear_cuda(x2.contiguous(), w.contiguous(),
                              b.contiguous(), activation)
    else:
        y = ref.fused_linear_ref(x2, w, b, activation)
    return y.reshape(*x.shape[:-1], w.shape[1])


def w8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor
              ) -> torch.Tensor:
    """W8A16: x [..., K] (bf16/f32) @ int8 w_q [K, N] * w_scale [1, N] ->
    x.dtype [..., N]."""
    kind = _device_kind(x, w_q, w_scale)
    x2 = x.reshape(-1, x.shape[-1])
    if kind == "cuda":
        y = w8_matmul_cuda(x2.contiguous(), w_q.contiguous(),
                           w_scale.reshape(-1).contiguous())
    else:
        y = ref.w8_matmul_plain(x2, w_q, w_scale)
    return y.reshape(*x.shape[:-1], w_q.shape[1])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0, tq: int = 128,
                    tk: int = 128) -> torch.Tensor:
    """Attention over q [B, H, Tq, D] and k, v [B, Hkv, Tk, D] -> [B, H,
    Tq, D], queries aligned bottom-right.

    ``tq``/``tk`` are the Pallas kernel's tiles; the CUDA kernel's are
    fixed, so on the card anything but the defaults raises (as ``build``
    does for a non-default ``KernelTuning``).  The plain version has no
    tiles.
    """
    kind = _device_kind(q, k, v)
    if kind == "cuda":
        if (tq, tk) != (128, 128):
            raise NotImplementedError(
                f"flash_attention: tiles tq={tq}, tk={tk} wait for "
                f"'Tuning and analysis' in ROADMAP.md; the CUDA kernel's "
                f"tiles are fixed")
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal, window)
    return ref.attention_ref(q, k, v, causal, window)
