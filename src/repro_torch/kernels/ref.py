"""Plain PyTorch versions of the hand-written kernels (the correctness contract).

Each ``*_ref`` is the function its kernel must compute.  The wrappers
run these for CPU tensors; ``chip_smoke.py`` holds every kernel against
its plain version on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.knn import knn_select, pairwise_sqdist

ACTIVATIONS = ("relu", "gelu", "none")


def knn_ref(samples: torch.Tensor, points: torch.Tensor, k: int
            ) -> torch.Tensor:
    """[..., S, C], [..., N, C] -> [..., S, k] int64 ascending-distance
    indices, the cross term summed elementwise in channel order (the
    same rounding as the kNN kernel)."""
    return knn_select(pairwise_sqdist(samples, points), k)


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
