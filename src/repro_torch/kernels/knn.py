"""kNN selection: the CUDA kernel ``csrc/knn.cu`` and its wrapper.

The port of ``repro.kernels.knn.knn_pallas``, batched over lanes: one
launch serves a whole dispatch, for any N and any 1 <= k <= N.  Given a
``radius`` the same launch is ``repro.core.knn.ball_query``: a pick
farther than the radius becomes the nearest pick.  :func:`knn` launches
the kernel for CUDA tensors, runs :func:`repro_torch.kernels.ref.knn_ref`
for CPU tensors, and raises on anything else.  ``knn_cuda.launches``
counts launches; ``radius_launches`` and ``k1_launches`` count those with
a radius and those at k = 1 (the seg head's upsample) among them, and
``templates`` the launches of each template by name (:func:`template`).
A ``tile`` (a ``KernelTuning`` knn value) pins ``knn_kernel``'s queries
a block.
"""
from __future__ import annotations

import collections
from typing import Optional

import torch

from repro_torch.core.knn import radius_sq
from repro_torch.kernels import ref, tuning

MAX_CHANNELS = 8
# csrc/knn.cu's knn_kernel: blocks a dispatch that queries_per_warp aims
# for (8 an SM).
_TARGET_BLOCKS = 1056
# csrc/knn.cu: past k = 32 or N = 1024 it runs k rounds of argmin, one
# warp a query, 4 warps a block on at most 264 blocks, each warp's
# distance row in shared memory while 4 rows fit in a block's 232448
# bytes, else in a scratch row of N floats.
_ROUND_ROWS = 264 * 4
_SMEM_ROW_FLOATS = 232448 // (4 * 4)


def _check(samples: torch.Tensor, points: torch.Tensor, k: int) -> None:
    if samples.ndim != 3 or points.ndim != 3:
        raise ValueError(f"knn takes samples [B, S, C] and points [B, N, C], "
                         f"got {tuple(samples.shape)} and "
                         f"{tuple(points.shape)}")
    if (samples.shape[0] != points.shape[0]
            or samples.shape[2] != points.shape[2]):
        raise ValueError(f"knn: batch and channel dims must agree, got "
                         f"{tuple(samples.shape)} and {tuple(points.shape)}")
    if not 1 <= k <= points.shape[1]:
        raise ValueError(f"knn: need 1 <= k <= N, got k={k}, "
                         f"N={points.shape[1]}")


def queries_per_warp(b: int, s: int) -> int:
    """``csrc/knn.cu``'s ``queries_per_warp``: knn_kernel's queries a
    warp when no tile is pinned, for about 1056 blocks a dispatch."""
    w = tuning.KNN_WARPS
    blocks = max(1, min(-(-s // w), -(-_TARGET_BLOCKS // b)))
    return -(-s // (w * blocks))


def template(b: int, s: int, n: int, k: int, tile=None) -> str:
    """The name of the kernel and tile a launch takes: ``rounds`` past
    N = 1024 or k = 32, else ``select_q<queries a block>``, by
    :func:`queries_per_warp` or as ``tile`` pins it."""
    if tile is not None:
        qpw = tuning.card_tile("knn", tile, (n, k))
    elif k > tuning.KNN_SELECT_K or n > tuning.KNN_SELECT_POINTS:
        return "rounds"
    else:
        qpw = queries_per_warp(b, s)
    return f"select_q{tuning.KNN_WARPS * qpw}"


def knn_cuda(samples: torch.Tensor, points: torch.Tensor, k: int,
             radius: Optional[float] = None, tile=None) -> torch.Tensor:
    """Launch the kNN kernel: [B, S, C], [B, N, C] f32 -> [B, S, k] int64
    (a ball query within ``radius``, if given), on :func:`template`'s
    kernel (``tile`` pins the queries a block)."""
    from repro_torch.kernels import _build
    _check(samples, points, k)
    r2 = radius_sq(radius)
    b, s, c = samples.shape
    n = points.shape[1]
    if c > MAX_CHANNELS:
        raise ValueError(f"knn kernel takes C <= {MAX_CHANNELS}, got {c}")
    for name, t in (("samples", samples), ("points", points)):
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"knn kernel needs a contiguous float32 CUDA "
                             f"{name} tensor, got {t.dtype} on {t.device}")
    if points.device != samples.device:
        raise ValueError("knn: samples and points on different devices")
    name = template(b, s, n, k, tile)
    qpw = 0 if tile is None else tuning.card_tile("knn", tile)
    out = torch.empty((b, s, k), dtype=torch.int64, device=samples.device)
    if b * s == 0:
        return out
    scratch = (torch.empty(_ROUND_ROWS * n, dtype=torch.float32,
                           device=samples.device)
               if n > _SMEM_ROW_FLOATS else None)
    _build.launch(
        "knn", samples.device, samples.data_ptr(), points.data_ptr(),
        out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        0 if scratch is None else scratch.numel(), b, s, n, c, k, r2, qpw)
    knn_cuda.launches += 1
    knn_cuda.templates[name] += 1
    knn_cuda.radius_launches += int(radius is not None)
    knn_cuda.k1_launches += int(k == 1)
    return out


def knn(samples: torch.Tensor, points: torch.Tensor, k: int,
        radius: Optional[float] = None, tile=None) -> torch.Tensor:
    """[B, S, C], [B, N, C] -> [B, S, k] int64 nearest-neighbour indices,
    ascending distance, ties to the lowest index; with ``radius``, each
    pick farther than it replaced by pick 0.  ``tile`` pins the kernel's
    queries a block (checked on CPU tensors too, then unused)."""
    if samples.is_cuda:
        return knn_cuda(samples.contiguous(), points.contiguous(), k, radius,
                        tile)
    if samples.device.type == "cpu" and points.device.type == "cpu":
        _check(samples, points, k)
        if tile is not None:
            tuning.card_tile("knn", tile, (points.shape[1], k))
        return ref.knn_ref(samples, points, k, radius)
    raise ValueError(f"knn: unsupported devices {samples.device} / "
                     f"{points.device}")


knn_cuda.launches = 0
knn_cuda.radius_launches = 0
knn_cuda.k1_launches = 0
knn_cuda.templates = collections.Counter()
