"""kNN grouping + geometric-affine normalization (HLS4PC §2.1, Fig. 2).

The paper's kNN engine computes every sample-to-point distance into a
distance buffer, then extracts the k nearest by repeatedly taking the
argmin and overwriting the pick with the format's maximum.  This module
is the composable form used by the model walk; ``knn``/``knn_batched``
and the ball query (``ball_query``/``ball_query_batched``: the k nearest,
each outside the radius replaced by the nearest) launch the hand-written
kernel (``repro_torch.kernels.knn``) for CUDA tensors and run the plain
version for CPU tensors.

Distances are ``s2 - 2*cross + p2`` with ``s2``, ``p2`` and ``cross``
each summed over the channels in order (x, then y, then z), one rounded
operation at a time.  The CUDA kernel does the same arithmetic without
FMA contraction, so kernel and plain version pick identical indices.
(``repro`` forms the cross term with a dot product, so near-tie swaps
against it are possible and are reported by the tests.)
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.sampling import gather_points


def _dot_in_order(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_c a[..., c] * b[..., c], added left to right."""
    acc = a[..., 0] * b[..., 0]
    for c in range(1, a.shape[-1]):
        acc = acc + a[..., c] * b[..., c]
    return acc


def pairwise_sqdist(samples: torch.Tensor, points: torch.Tensor
                    ) -> torch.Tensor:
    """[..., S, C], [..., N, C] -> [..., S, N] squared distances."""
    s2 = _dot_in_order(samples, samples)[..., :, None]        # [..., S, 1]
    p2 = _dot_in_order(points, points)[..., None, :]          # [..., 1, N]
    cross = _dot_in_order(samples[..., :, None, :], points[..., None, :, :])
    return s2 - 2.0 * cross + p2


def knn_select(dist: torch.Tensor, k: int) -> torch.Tensor:
    """k rounds of (argmin, overwrite with the float maximum).

    dist [..., S, N] -> int64 indices [..., S, k] in ascending order;
    ties go to the lowest index, as ``torch.argmin`` and ``jnp.argmin``
    both return the first minimum.
    """
    d = dist.clone()
    big = torch.finfo(d.dtype).max
    out = []
    for _ in range(k):
        j = torch.argmin(d, dim=-1, keepdim=True)
        out.append(j)
        d.scatter_(-1, j, big)
    return torch.cat(out, dim=-1)


def radius_sq(radius: Optional[float]) -> float:
    """The ball's squared radius as ``repro.core.knn.ball_query`` forms it
    (the radius rounded to float32, squared in float32); +inf for None,
    which is plain kNN."""
    if radius is None:
        return float("inf")
    if not radius > 0:      # also rejects NaN
        raise ValueError(f"ball-query radius must be positive, got "
                         f"{radius!r}")
    r = torch.tensor(radius, dtype=torch.float32)
    return float(r * r)


def ball_fill(dist: torch.Tensor, idx: torch.Tensor, r2: float
              ) -> torch.Tensor:
    """PointNet++'s fill: each pick of ``idx`` [..., S, k] whose distance
    in ``dist`` [..., S, N] exceeds ``r2`` becomes pick 0, the nearest."""
    sel = torch.gather(dist, -1, idx)
    return torch.where(sel <= r2, idx, idx[..., :1])


def knn_batched(samples: torch.Tensor, points: torch.Tensor, k: int
                ) -> torch.Tensor:
    """[B, S, C], [B, N, C] -> [B, S, k] int64 (kernel on CUDA tensors)."""
    from repro_torch.kernels import knn as knn_kernel
    return knn_kernel.knn(samples, points, k)


def knn(samples: torch.Tensor, points: torch.Tensor, k: int) -> torch.Tensor:
    """[S, C], [N, C] -> [S, k] nearest-neighbour indices."""
    return knn_batched(samples[None], points[None], k)[0]


def ball_query_batched(samples: torch.Tensor, points: torch.Tensor, k: int,
                       radius: float) -> torch.Tensor:
    """Ball query: the k nearest, each one outside ``radius`` replaced by
    the nearest (the kNN kernel's fill on CUDA tensors).  ``radius=inf``
    is plain kNN, bit for bit.  [B, S, C], [B, N, C] -> [B, S, k]."""
    from repro_torch.kernels import knn as knn_kernel
    return knn_kernel.knn(samples, points, k, radius=radius)


def ball_query(samples: torch.Tensor, points: torch.Tensor, k: int,
               radius: float) -> torch.Tensor:
    """[S, C], [N, C] -> [S, k] ball-query indices."""
    return ball_query_batched(samples[None], points[None], k, radius)[0]


def gather_neighbors(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats [B, N, C], idx [B, S, k] -> [B, S, k, C]."""
    b, s, k = idx.shape
    c = feats.shape[-1]
    flat = idx.reshape(b, s * k, 1).expand(-1, -1, c)
    return torch.gather(feats, 1, flat).reshape(b, s, k, c)


def group_sigma(off: torch.Tensor, per_sample: bool = False,
                eps: float = 1e-5) -> torch.Tensor:
    """``sqrt(mean(off**2) + eps)`` over offsets [B, S, k, C].

    ``per_sample`` takes the mean per cloud (over dims 1, 2, 3, giving
    [B, 1, 1, 1]) instead of over the whole batch (a 0-dim tensor).

    ``off * off`` is rounded in float32 and summed in float64, the mean
    is a float64 division by a device tensor rounded once to float32,
    and its root is taken in float64 and rounded once: the card and the
    CPU get the same sigma bit for bit, and so do the unfused path and
    the ``grouped_transfer`` kernel, which forms it the same way
    (``repro`` sums in float32; the two differ by about an ulp).
    """
    sq = off * off
    if per_sample:
        total = sq.sum(dim=(1, 2, 3), keepdim=True, dtype=torch.float64)
        count = sq[0].numel()
    else:
        total = sq.sum(dtype=torch.float64)
        count = sq.numel()
    # a tensor divisor: CUDA would multiply by a rounded 1/count instead
    mean = (total / total.new_full((), float(count))).to(off.dtype)
    # float32 sqrt differs by an ulp between PyTorch's CUDA and CPU
    # kernels; a float64 sqrt rounded once to float32 is the correctly
    # rounded float32 root on both
    return torch.sqrt((mean + eps).double()).to(off.dtype)


def normalize_group(grouped: torch.Tensor, centers: torch.Tensor,
                    params: Optional[dict], mode: str = "affine",
                    eps: float = 1e-5,
                    per_sample: bool = False) -> torch.Tensor:
    """(g - c) / sigma [* alpha + beta] over grouped [B, S, k, C].

    ``sigma = sqrt(mean(off**2) + eps)`` (:func:`group_sigma`) and the
    division adds ``eps`` again, both as in ``repro.core.knn``.
    ``per_sample`` takes the mean per cloud instead of over the batch.
    """
    off = grouped - centers[:, :, None, :]
    if mode == "center":
        return off
    out = off / (group_sigma(off, per_sample, eps) + eps)
    if mode == "norm":
        return out
    if mode == "affine":
        if params is None:
            raise ValueError("affine mode needs alpha/beta params")
        return out * params["alpha"] + params["beta"]
    raise ValueError(f"unknown normalize mode: {mode}")


def neighbor_index(new_xyz: torch.Tensor, xyz: torch.Tensor, k: int,
                   radius: Optional[float] = None) -> torch.Tensor:
    """The mapping half of the grouper: [B, S, 3], [B, N, 3] -> [B, S, k];
    ``radius=None`` is plain kNN, a float the ball query."""
    if radius is None:
        return knn_batched(new_xyz, xyz, k)
    return ball_query_batched(new_xyz, xyz, k, radius)


def group_with_idx(xyz: torch.Tensor, feats: torch.Tensor,
                   sample_idx: torch.Tensor, nbr_idx: torch.Tensor,
                   affine_params: Optional[dict], mode: str,
                   per_sample_norm: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The arithmetic half: gather -> normalize -> concat, indices given.

    Returns new_xyz [B, S, 3], centre feats [B, S, C] and grouped
    [B, S, k, 2C] (normalized neighbours ++ broadcast centre).
    """
    new_xyz = gather_points(xyz, sample_idx)
    center_f = gather_points(feats, sample_idx)
    grouped = gather_neighbors(feats, nbr_idx)
    grouped = normalize_group(grouped, center_f, affine_params, mode,
                              per_sample=per_sample_norm)
    center_b = center_f[:, :, None, :].expand_as(grouped)
    return new_xyz, center_f, torch.cat([grouped, center_b], dim=-1)


def group_points(xyz: torch.Tensor, feats: torch.Tensor,
                 sample_idx: torch.Tensor, k: int,
                 affine_params: Optional[dict], mode: str,
                 per_sample_norm: bool = False,
                 radius: Optional[float] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full local grouper: sample -> kNN (or the ball query within
    ``radius``) -> gather -> normalize -> concat."""
    sample_idx = sample_idx.to(xyz.device, torch.int64)
    nbr_idx = neighbor_index(gather_points(xyz, sample_idx), xyz, k, radius)
    return group_with_idx(xyz, feats, sample_idx, nbr_idx, affine_params,
                          mode, per_sample_norm)
