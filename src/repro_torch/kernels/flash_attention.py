"""Flash attention: the CUDA kernel ``csrc/flash_attention.cu``.

The port of ``repro.kernels.flash_attention.flash_attention_pallas``:
online-softmax GQA attention over q [B, H, Tq, D] and k, v [B, Hkv, Tk,
D] (bf16 or f32) with a causal and a sliding-window mask, queries aligned
bottom-right.  ``flash_attention_cuda.launches`` counts launches and
``.templates`` those of each route and tile by name.  The source has two
kernels and the route is fixed by dtype and head dim (``route``): bf16 at
D = 64 or 128 runs on the tensor cores (wgmma, TMA-fed K/V ring, 128
queries by 128 keys a tile); f32, and bf16 at D = 16 or 32, on the CUDA
cores (FFMA, 64 by 64).  A pinned ``tile`` must be the route's own
(``kernels.tuning.FLASH_TILES``).
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels import tuning

HEAD_DIMS = (16, 32, 64, 128)


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel a call of this dtype and head dim launches, as the C
    launch function fixes it: ``"wgmma"`` or ``"ffma"``."""
    return "wgmma" if dtype == torch.bfloat16 and d in (64, 128) else "ffma"


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int = 0, tile=None
                         ) -> torch.Tensor:
    """Launch the kernel: [B, H, Tq, D] x [B, Hkv, Tk, D] -> q's shape, on
    the route :func:`route` names (a pinned (tq, tk) ``tile`` must be the
    route's; ``ValueError`` otherwise)."""
    from repro_torch.kernels import _build
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q [B, H, Tq, D] and k, v [B, Hkv, "
                         f"Tk, D] expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv < 1 or h % hkv:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)} (same B and D, H a multiple "
                         f"of Hkv)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {d}")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes bf16 or f32 q, k, v of one "
                         f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash_attention kernel needs contiguous CUDA "
                             f"tensors on one device; {name} is on "
                             f"{t.device}")
    rt = route(q.dtype, d)
    bq, bkv = (tuning.FLASH_TILES[rt] if tile is None
               else tuning.card_tile("flash_attention", tile, route=rt))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    sm_scale = 1.0 / d ** 0.5          # rounded to f32 by ctypes
    _build.launch(
        "flash_attention", q.device, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), b, h, hkv, tq, tk, d, int(causal),
        int(window), int(q.dtype == torch.bfloat16), sm_scale)
    flash_attention_cuda.launches += 1
    flash_attention_cuda.templates[f"{rt}_{bq}x{bkv}"] += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.templates = collections.Counter()
