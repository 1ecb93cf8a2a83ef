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
product takes, :func:`w8_route` the route of ``csrc/w8_matmul.cu``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build

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


# csrc/w8_matmul.cu's routes, by their code in its launch switch.
W8_ROUTES = ("tiled", "stream", "wgmma")
# The most rows of x that take the stream route: at tinyllama's MLP
# shapes (NVIDIA H100 80GB HBM3, 700 W; PERF.md) it beats the wgmma route
# up to 64 rows of bf16 x (by 1.3x and 3.2x there) and the tiled route at
# 32 rows of f32 x (by 4.4x and 12x).
STREAM_MAX_M = 64
# The stream kernels' strip width, rows a block (f32 x, bf16 x) and rows
# a K split (csrc/w8_matmul.cu, namespace stream: COLS, MR_MAX, MMA_ROWS,
# KS_MAX).
_STREAM_COLS, _STREAM_KS_MAX = 128, 512
_STREAM_ROWS = {torch.float32: 8, torch.bfloat16: 16}
# Blocks the stream route aims for: two on each of an H100's 132 SMs.
_STREAM_BLOCKS = 2 * 132


class W8Route(NamedTuple):
    """A route of ``csrc/w8_matmul.cu`` and, for ``stream``, the rows of
    w a K split takes (``ks``; the scratch holds ``splits(k)`` of them)."""
    name: str
    ks: int = 0

    @property
    def code(self) -> int:
        return W8_ROUTES.index(self.name)

    def splits(self, k: int) -> int:
        return -(-k // self.ks) if self.ks else 1


def w8_split_rows(m: int, k: int, n: int, dtype: torch.dtype) -> int:
    """Rows of w a K split of the stream route takes: a multiple of 16,
    at most ``_STREAM_KS_MAX``, and short enough that strips x splits x
    row chunks reach ``_STREAM_BLOCKS`` (no split shorter than 32 rows
    where K allows)."""
    strips = -(-n // _STREAM_COLS)
    chunks = -(-m // _STREAM_ROWS[dtype])
    want = min(-(-_STREAM_BLOCKS // (strips * chunks)), -(-k // 32))
    ks = -(-k // max(want, 1))
    return min(_STREAM_KS_MAX, 16 * -(-ks // 16))


def w8_route(m: int, k: int, n: int, dtype: torch.dtype,
             aligned: bool = True) -> W8Route:
    """The route of ``x [m, k] @ w_q [k, n]``.  Both fast routes read w
    in 16-byte rows, so they need 16-byte aligned data and N % 16 == 0:
    ``stream`` for at most ``STREAM_MAX_M`` rows (bound by the weight's
    bytes), ``wgmma`` for more rows of bf16 x with K % 8 == 0 (TMA's row
    stride; bound by the tensor cores); ``tiled`` for every other shape,
    f32 x at more rows among them (the tensor cores would round it to
    TF32)."""
    if aligned and k > 0 and n % 16 == 0:
        if m <= STREAM_MAX_M:
            return W8Route("stream", w8_split_rows(m, k, n, dtype))
        if dtype == torch.bfloat16 and k % 8 == 0:
            return W8Route("wgmma")
    return W8Route("tiled")


def w8_matmul_cuda(x: torch.Tensor, w_q: torch.Tensor,
                   w_scale: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: x [M, K] (bf16/f32) @ int8 [K, N] * w_scale [N]
    -> x.dtype [M, N], by the route :func:`w8_route` picks."""
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
    route = w8_route(m, k, n, x.dtype, _build.aligned16(x, w_q, w_scale))
    scratch = (torch.empty((route.splits(k), m, n), dtype=torch.float32,
                           device=x.device)
               if route.name == "stream" else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _build.launcher("w8_matmul")(
        x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
        0 if scratch is None else scratch.data_ptr(), m, k, n,
        int(x.dtype == torch.bfloat16), route.code, route.ks, stream)
    _build.check("w8_matmul", code)
    w8_matmul_cuda.launches += 1
    return out


w8_matmul_cuda.launches = 0
