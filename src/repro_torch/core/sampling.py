"""Point sampling: LFSR-driven URS (HLS4PC §2.1), bit-exact with ``repro``, and FPS.

The paper replaces Farthest Point Sampling by URS driven by Galois LFSRs
seeded identically at training and deployment time.  The JAX package
does the arithmetic in ``uint32``; here it runs in ``int64`` with
explicit ``& 0xFFFFFFFF`` masks (every value stays below 2**32, and the
seed hash wraps mod 2**32 as the ``uint32`` product does), so states,
words and indices are bit-identical to ``repro.core.sampling``.

The walk is sequential and tiny (one word per stream per step), so it
runs on the host in NumPy whatever device the clouds live on: a state
is a CPU ``int64`` tensor of ``uint32`` values, and only the indices
travel to the clouds' device.

Farthest Point Sampling, the baseline sampler of PointMLP-Elite that URS
replaces, is data-dependent and stateless: :func:`fps` runs the whole
sampler on the clouds' device, as one launch of the hand-written kernel
(``repro_torch.kernels.fps``) for CUDA tensors and as its plain version
for CPU tensors.  It picks exactly the indices of ``repro.core.sampling.
fps_batched``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# Primitive polynomials (Galois tap masks) giving maximal period 2^n - 1.
GALOIS_TAPS = {
    8: 0xB8,
    16: 0xB400,
    24: 0xE10000,
    32: 0xA3000000,
}
_MASK32 = 0xFFFFFFFF


def _host_state(state) -> np.ndarray:
    if isinstance(state, torch.Tensor):
        state = state.detach().cpu().to(torch.int64).numpy()
    return np.asarray(state, np.int64) & _MASK32


def lfsr_step(state: torch.Tensor, nbits: int = 16) -> torch.Tensor:
    """One Galois LFSR step of every stream (``state`` nonzero)."""
    taps = GALOIS_TAPS[nbits]
    s = state.to(torch.int64) & _MASK32
    shifted = s >> 1
    return torch.where((s & 1) == 1, shifted ^ taps, shifted)


def _sequence(s: np.ndarray, n_out: int, nbits: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    taps = GALOIS_TAPS[nbits]
    vals = np.empty((n_out, s.shape[0]), np.int64)
    for i in range(n_out):
        s = np.where((s & 1) == 1, (s >> 1) ^ taps, s >> 1)
        vals[i] = s
    return s, vals


def lfsr_sequence(state: torch.Tensor, n_out: int, nbits: int = 16
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_out`` words per stream.

    Returns (new_state [streams], values [n_out, streams]), both int64
    CPU tensors of uint32 values in [1, 2^nbits - 1].
    """
    s, vals = _sequence(_host_state(state), n_out, nbits)
    return torch.from_numpy(s), torch.from_numpy(vals)


def seed_streams(seed: int, n_streams: int, nbits: int = 16) -> torch.Tensor:
    """``n_streams`` distinct nonzero LFSR seeds derived from ``seed``
    (Knuth multiplicative hash mod 2**32, clipped to ``nbits``)."""
    mask = (1 << nbits) - 1
    base = (int(seed) * 2654435761) & _MASK32
    idx = np.arange(n_streams, dtype=np.int64)
    s = (base + idx * 40503) & _MASK32
    s = (s >> 4) & mask
    return torch.from_numpy(np.where(s == 0, 1, s).astype(np.int64))


def urs_indices(state: torch.Tensor, n_points: int, n_samples: int,
                nbits: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """URS indices from stream 0: successive words mod ``n_points``.

    Every stream advances ``n_samples`` steps, as in the JAX walk.
    Returns (new_state [streams], indices [n_samples] int64), on the CPU.
    """
    s, vals = _sequence(_host_state(state), n_samples, nbits)
    return torch.from_numpy(s), torch.from_numpy(vals[:, 0] % n_points)


def urs_indices_batched(state: torch.Tensor, n_points: int, n_samples: int,
                        batch: int, nbits: int = 16
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LFSR stream per batch element.

    Returns (new_state [streams], indices [batch, n_samples] int64).
    """
    host = _host_state(state)
    if host.shape[0] < batch:
        raise ValueError(f"need one LFSR stream per batch element: "
                         f"{host.shape[0]} streams for a batch of {batch}")
    s, vals = _sequence(host, n_samples, nbits)
    return (torch.from_numpy(s),
            torch.from_numpy(np.ascontiguousarray(vals[:, :batch].T
                                                  % n_points)))


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, S] -> [B, S, C]."""
    idx = idx.to(points.device, torch.int64)
    return torch.gather(points, 1,
                        idx[..., None].expand(-1, -1, points.shape[-1]))


def fps(points: torch.Tensor, n_samples: int, tile=None) -> torch.Tensor:
    """Farthest Point Sampling: [B, N, C] -> [B, S] int64 indices on the
    points' device (the kernel on CUDA tensors; ``tile`` pins its
    register tile), starting at index 0, ties to the lowest index."""
    from repro_torch.kernels import fps as fps_kernel
    return fps_kernel.fps(points, n_samples, tile)
