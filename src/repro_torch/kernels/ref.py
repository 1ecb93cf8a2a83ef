"""Plain PyTorch versions of the hand-written kernels (the correctness contract).

Each ``*_ref`` is the function its kernel must compute.  The wrappers
run these for CPU tensors; ``chip_smoke.py`` holds every kernel against
its plain version on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.knn import (ball_fill, gather_neighbors, group_sigma,
                                  knn_select, pairwise_sqdist, radius_sq)

ACTIVATIONS = ("relu", "gelu", "none")
EPS = 1e-5                      # the normalization's eps (both terms)


def knn_ref(samples: torch.Tensor, points: torch.Tensor, k: int,
            radius: Optional[float] = None) -> torch.Tensor:
    """[..., S, C], [..., N, C] -> [..., S, k] int64 ascending-distance
    indices, the cross term summed elementwise in channel order (the
    same rounding as the kNN kernel).  With ``radius``, the ball query
    of ``repro.core.knn.ball_query``: a pick whose distance exceeds
    ``radius_sq(radius)`` is replaced by pick 0."""
    dist = pairwise_sqdist(samples, points)
    idx = knn_select(dist, k)
    if radius is None:
        return idx
    return ball_fill(dist, idx, radius_sq(radius))


def int8_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor,
                    a_scale: torch.Tensor, w_scale: torch.Tensor,
                    rows_per_lane: int) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> f32 [M, N], dequantized.

    The int32 accumulator is formed in float64, exact for every K the
    pipeline uses (each partial sum is an integer below 2**53; PyTorch
    has no integer CUDA matmul).  The epilogue is ``f32(acc) * s`` with
    ``s = a_scale[row // rows_per_lane] * w_scale[col]`` formed in f32
    first: the order of ``repro.kernels.ops.int8_matmul``.
    """
    acc = (x_q.double() @ w_q.double()).to(torch.int32)
    lane_scale = a_scale.repeat_interleave(rows_per_lane)     # [M]
    scale = lane_scale[:, None] * w_scale.reshape(1, -1)      # f32 [M, N]
    return acc.to(torch.float32) * scale


def w8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                    w_scale: torch.Tensor) -> torch.Tensor:
    """W8A16: x [M, K] (bf16/f32) @ int8 w_q [K, N] * w_scale [1, N] ->
    x.dtype [M, N].

    The Pallas kernel's arithmetic (``int8_matmul.py::_w8_kernel``): x and
    the int8 weight widened (exactly), products summed in f32, the sum
    times the scale in f32, rounded to ``x.dtype``.  Not the JAX ``ref``
    oracle, which dequantizes the weight in ``x.dtype`` before the
    product.
    """
    acc = x.float() @ w_q.float()
    return (acc * w_scale.reshape(1, -1).float()).to(x.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, sliding_window: int = 0
                  ) -> torch.Tensor:
    """GQA attention oracle: q [B, H, Tq, D], k/v [B, Hkv, Tk, D] ->
    [B, H, Tq, D] in q's dtype (``repro.kernels.ref.attention_ref``).

    f32 logits divided by sqrt(D), queries aligned bottom-right
    (``qpos = i + Tk - Tq``), masked logits set to -1e30, f32 softmax.
    Query head h reads KV head h // (H // Hkv).
    """
    b, h, tq, d = q.shape
    rep = h // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).float()
    v = v.repeat_interleave(rep, dim=1).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k)
    logits = logits / logits.new_full((), math.sqrt(d))
    tk = k.shape[2]
    qpos = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
    kpos = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if sliding_window > 0:
        mask &= kpos > qpos - sliding_window
    logits = torch.where(mask, logits, logits.new_full((), -1e30))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v).to(q.dtype)


def gelu_tanh(y: torch.Tensor) -> torch.Tensor:
    """GELU in its tanh form (``jax.nn.gelu``'s default)."""
    return torch.nn.functional.gelu(y, approximate="tanh")


def fused_linear_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     activation: str = "relu") -> torch.Tensor:
    """act(x @ w + b) for x [M, K], w [K, N], b [N]."""
    y = x @ w + b
    if activation == "relu":
        return torch.relu(y)
    if activation == "gelu":
        return gelu_tanh(y)
    if activation == "none":
        return y
    raise ValueError(f"activation must be one of {ACTIVATIONS}, "
                     f"got {activation!r}")


def fps_ref(points: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Farthest Point Sampling: [B, N, C] f32 -> [B, S] int64 indices.

    The in-order loop of ``repro.core.sampling.fps``, on the whole batch
    at once: start at index 0; each step forms ``d = (dx*dx + dy*dy) +
    dz*dz`` (channels added left to right) to the last pick, folds it
    into a running minimum that starts at +inf, and picks its argmax
    (ties to the lowest index, as ``jnp.argmax`` and ``torch.argmax``).
    """
    b, n, c = points.shape
    idx = torch.zeros((b, n_samples), dtype=torch.int64,
                      device=points.device)
    dists = torch.full((b, n), float("inf"), dtype=torch.float32,
                       device=points.device)
    rows = torch.arange(b, device=points.device)
    last = points[:, 0, :]
    for s in range(1, n_samples):
        diff = points - last[:, None, :]
        sq = diff * diff
        d = sq[..., 0]
        for ch in range(1, c):
            d = d + sq[..., ch]
        dists = torch.minimum(dists, d)
        nxt = torch.argmax(dists, dim=1)
        idx[:, s] = nxt
        last = points[rows, nxt]
    return idx


def grouped_transfer_ref(feats: torch.Tensor, nidx: torch.Tensor,
                         centers: torch.Tensor, sigma, alpha: torch.Tensor,
                         beta: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         *, normalize: bool = True, affine: bool = True,
                         act: bool = True) -> torch.Tensor:
    """Gather -> normalize -> concat -> ``x @ w + b`` -> ReLU, per cloud.

    feats [B, N, C], nidx [B, S, k], centers [B, S, C] -> [B, S, k,
    C_out].  ``sigma`` is the normalization scale per cloud ([B] f32,
    given), or None to compute it per cloud (``group_sigma``, the
    ``pallas_call`` of ``grouped_transfer.py:149``).  Under ``affine``
    the normalized offsets become ``* alpha + beta`` ([C] each).
    """
    off = gather_neighbors(feats, nidx) - centers[:, :, None, :]
    if normalize:
        if sigma is None:
            sigma = group_sigma(off, per_sample=True, eps=EPS)
        else:
            sigma = sigma.reshape(-1, 1, 1, 1)
        off = off / (sigma + EPS)
    if affine:
        off = off * alpha + beta
    x = torch.cat([off, centers[:, :, None, :].expand_as(off)], dim=-1)
    y = x @ w + b
    return torch.relu(y) if act else y
