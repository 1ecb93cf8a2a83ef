"""Public wrappers of the CUDA kernels, on tensors of any leading shape.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version (``repro_torch.kernels.ref``) for CPU tensors; it never falls
back from one to the other.  A ``tile`` (a ``KernelTuning`` value; None:
the wrapper's own rule) pins a kernel's template on the card and is
checked, then unused, on the CPU (``repro_torch.kernels.tuning``).
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.core.quant import compute_scale, qrange
from repro_torch.kernels import fps as fps_kernel
from repro_torch.kernels import knn as knn_kernel
from repro_torch.kernels import ref, tuning
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 route)
from repro_torch.kernels.fused_linear import fused_linear_cuda
from repro_torch.kernels.int8_matmul import int8_matmul_cuda, w8_matmul_cuda


def _device_kind(*ts: torch.Tensor) -> str:
    kinds = {t.device.type for t in ts}
    if len(kinds) != 1 or not kinds <= {"cuda", "cpu"}:
        raise ValueError(f"tensors must all lie on one CUDA device or all "
                         f"on the CPU, got {sorted(kinds)}")
    return kinds.pop()


def knn(samples: torch.Tensor, points: torch.Tensor, k: int,
        tile=None) -> torch.Tensor:
    """samples [..., S, C], points [..., N, C] -> [..., S, k] int64: the
    k nearest points of each sample (``repro.kernels.ops.knn``'s twin,
    through ``kernels.knn.knn``)."""
    lead = samples.shape[:-2]
    out = knn_kernel.knn(samples.reshape(-1, *samples.shape[-2:]),
                         points.reshape(-1, *points.shape[-2:]), k,
                         tile=tile)
    return out.reshape(*lead, *out.shape[-2:])


def knn_batched(samples: torch.Tensor, points: torch.Tensor, k: int,
                tile=None) -> torch.Tensor:
    """[B, S, C], [B, N, C] -> [B, S, k] (``repro.kernels.ops.
    knn_batched``'s twin: one launch for the batch)."""
    return knn(samples, points, k, tile)


def fps(points: torch.Tensor, n_samples: int, tile=None) -> torch.Tensor:
    """points [..., N, C] -> [..., S] int64 farthest-point indices
    (``repro.kernels.ops.fps``'s twin, through ``kernels.fps.fps``)."""
    lead = points.shape[:-2]
    out = fps_kernel.fps(points.reshape(-1, *points.shape[-2:]), n_samples,
                         tile=tile)
    return out.reshape(*lead, n_samples)


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
                a_bits: int = 8, lanes: int = 1, tile=None) -> torch.Tensor:
    """W8A8: quantize activations on the fly, then the int8 kernel.

    x f32 [..., K], w_q int8 [K, N], w_scale f32 [1, N] -> f32 [..., N].
    ``lanes`` splits the leading dim into that many clouds, each with its
    own activation scale; ``tile`` pins the kernel's template.
    """
    kind = _device_kind(x, w_q, w_scale)
    x_q, a_scale = quantize_activations(x, a_bits, lanes)
    rows_per_lane = x_q.shape[0] // lanes
    w_scale = w_scale.reshape(-1)
    if kind == "cuda":
        y = int8_matmul_cuda(x_q, w_q.contiguous(), a_scale.contiguous(),
                             w_scale.contiguous(), rows_per_lane, tile)
    else:
        if tile is not None:
            tuning.card_tile("int8_matmul", tile)
        y = ref.int8_matmul_ref(x_q, w_q, a_scale, w_scale, rows_per_lane)
    return y.reshape(*x.shape[:-1], w_q.shape[1])


def fused_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 activation: str = "relu", tile=None) -> torch.Tensor:
    """act(x @ w + b) over x [..., K] -> [..., N]; ``tile`` pins the
    kernel's template."""
    kind = _device_kind(x, w, b)
    x2 = x.reshape(-1, x.shape[-1])
    if kind == "cuda":
        y = fused_linear_cuda(x2.contiguous(), w.contiguous(),
                              b.contiguous(), activation, tile)
    else:
        if tile is not None:
            tuning.card_tile("fused_linear", tile)
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

    ``tq``/``tk`` are ``KernelTuning.flash_attention``: at the default
    (128, 128) the route's own tile; any other pair must be the tile of
    the route that q's dtype and head dim select (``ValueError``
    otherwise, on either device).  The plain version has no tiles.

    Forward only: under grad with any of q, k, v taking a gradient it
    raises ``NotImplementedError`` on either device, before any launch.
    The kernel writes its output outside autograd, so a gradient would
    come back as zeros without a word.  Fake and meta tensors (the
    dry-run's) raise ``ValueError``: the launch hands the kernel raw
    pointers, and they have no memory behind them.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward, in the port or in the JAX "
            "reference (its Pallas kernel has no VJP): train with "
            "attn_impl='xla' or 'xla_chunked', or call it under "
            "torch.no_grad()")
    if all(t.device.type == "meta" or is_fake(t) for t in (q, k, v)):
        raise ValueError(
            "flash_attention: fake or meta tensors have no memory for the "
            "CUDA kernel to read; count a step with attn_impl='xla' or "
            "'xla_chunked' (every JAX config and dry-run variant uses one "
            "of them)")
    kind = _device_kind(q, k, v)
    tile = (None if (tq, tk) == tuning.DEFAULT_TUNING.flash_attention
            else (tq, tk))
    if kind == "cuda":
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal, window, tile)
    if tile is not None:
        tuning.card_tile("flash_attention", tile,
                         route=route(q.dtype, q.shape[-1]))
    return ref.attention_ref(q, k, v, causal, window)
