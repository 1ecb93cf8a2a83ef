"""The int8 matrix products: the CUDA kernels ``csrc/int8_matmul.cu`` and
``csrc/w8_matmul.cu``.

``int8_matmul_cuda`` ports ``repro.kernels.int8_matmul.
int8_matmul_pallas`` (A8W8): int8 activations ``[M, K]`` times int8
weights ``[K, N]`` into an int32 accumulator, dequantized by
``a_scale[row // rows_per_lane] * w_scale[col]``.  ``w8_matmul_cuda``
ports ``w8_matmul_pallas`` (W8A16): bf16/f32 activations times int8
weights widened in the tile, f32 sums, a per-column scale, the result in
the activations' dtype.  No model path calls it, in the JAX package or
here.  Each wrapper counts its launches on ``<fn>.launches``.
:func:`template` names the template of ``csrc/int8_matmul.cu`` that a
product takes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# csrc/int8_matmul.cu keeps a block's [K, BN] slice of w_q in shared
# memory; at K <= 1024 it fits beside the ring at every BN.
MAX_K = 1024


def template(k: int, n: int, aligned: bool = True) -> _build.GemmTemplate:
    """The template of ``csrc/int8_matmul.cu`` for ``[M, K] @ [K, N]``:
    the column tile follows N; 16-byte copies (``vec``) need 16-byte
    aligned operands, K % 16 == 0 (rows of x_q on 16-byte boundaries) and
    N % 4 == 0 (whole 4-column words of w_q)."""
    return _build.gemm_template(n, aligned and k % 16 == 0 and n % 4 == 0)


def _check(x_q, w_q, a_scale, w_scale, rows_per_lane) -> None:
    m, k = x_q.shape
    if w_q.ndim != 2 or w_q.shape[0] != k:
        raise ValueError(f"int8_matmul: x_q [M, K={k}] needs w_q [K, N], "
                         f"got {tuple(w_q.shape)}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError(f"int8_matmul takes int8 operands, got "
                         f"{x_q.dtype} and {w_q.dtype}")
    if rows_per_lane < 1 or m % rows_per_lane:
        raise ValueError(f"int8_matmul: rows_per_lane={rows_per_lane} must "
                         f"divide M={m}")
    if k > MAX_K:
        raise ValueError(f"int8_matmul: K={k} is past the kernel's "
                         f"{MAX_K} (w_q's slice lives in shared memory)")
    lanes = m // rows_per_lane
    if a_scale.numel() != lanes or w_scale.numel() != w_q.shape[1]:
        raise ValueError(f"int8_matmul: a_scale needs {lanes} entries and "
                         f"w_scale {w_q.shape[1]}, got {a_scale.numel()} "
                         f"and {w_scale.numel()}")


def int8_matmul_cuda(x_q: torch.Tensor, w_q: torch.Tensor,
                     a_scale: torch.Tensor, w_scale: torch.Tensor,
                     rows_per_lane: int) -> torch.Tensor:
    """Launch the kernel: int8 [M, K] @ int8 [K, N] -> f32 [M, N]."""
    _check(x_q, w_q, a_scale, w_scale, rows_per_lane)
    tensors = (("x_q", x_q), ("w_q", w_q), ("a_scale", a_scale),
               ("w_scale", w_scale))
    for name, t in tensors:
        if not t.is_cuda or not t.is_contiguous() or t.device != x_q.device:
            raise ValueError(f"int8_matmul kernel needs contiguous CUDA "
                             f"tensors on one device; {name} is on "
                             f"{t.device}")
    for name, t in tensors[2:]:
        if t.dtype != torch.float32:
            raise ValueError(f"int8_matmul: {name} must be float32, "
                             f"got {t.dtype}")
    m, k = x_q.shape
    n = w_q.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
    if m * n == 0:
        return out
    tmpl = template(k, n, _build.aligned16(x_q, w_q))
    stream = torch.cuda.current_stream(x_q.device).cuda_stream
    code = _build.launcher("int8_matmul")(
        x_q.data_ptr(), w_q.data_ptr(), a_scale.data_ptr(),
        w_scale.data_ptr(), out.data_ptr(), m, k, n, rows_per_lane,
        tmpl.code, stream)
    _build.check("int8_matmul", code)
    int8_matmul_cuda.launches += 1
    return out


int8_matmul_cuda.launches = 0


def w8_matmul_cuda(x: torch.Tensor, w_q: torch.Tensor,
                   w_scale: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: x [M, K] (bf16/f32) @ int8 [K, N] * w_scale [N]
    -> x.dtype [M, N]."""
    if x.ndim != 2 or w_q.ndim != 2 or w_q.shape[0] != x.shape[1]:
        raise ValueError(f"w8_matmul: x [M, K] needs w_q [K, N], got "
                         f"{tuple(x.shape)} and {tuple(w_q.shape)}")
    m, k = x.shape
    n = w_q.shape[1]
    if x.dtype not in (torch.bfloat16, torch.float32) or \
            w_q.dtype != torch.int8 or w_scale.dtype != torch.float32:
        raise ValueError(f"w8_matmul takes bf16/f32 x, int8 w_q and f32 "
                         f"w_scale, got {x.dtype}, {w_q.dtype}, "
                         f"{w_scale.dtype}")
    if w_scale.numel() != n:
        raise ValueError(f"w8_matmul: w_scale needs {n} entries, got "
                         f"{w_scale.numel()}")
    for name, t in (("x", x), ("w_q", w_q), ("w_scale", w_scale)):
        if not t.is_cuda or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"w8_matmul kernel needs contiguous CUDA tensors "
                             f"on one device; {name} is on {t.device}")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m * n == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _build.launcher("w8_matmul")(
        x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), out.data_ptr(), m,
        k, n, int(x.dtype == torch.bfloat16), stream)
    _build.check("w8_matmul", code)
    w8_matmul_cuda.launches += 1
    return out


w8_matmul_cuda.launches = 0
