"""Farthest Point Sampling: the CUDA kernel ``csrc/fps.cu`` and its wrapper.

The port of ``repro.kernels.fps.fps_update_pallas`` with the loop around
it, ``fps_pallas``: one launch runs a stage's whole sampler for every cloud
of a dispatch (update, argmax and next centroid for each of the S
steps).  :func:`fps` launches the kernel for CUDA tensors, runs
:func:`repro_torch.kernels.ref.fps_ref` for CPU tensors, and raises on
anything else.  ``fps_cuda.launches`` counts launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

_THREADS = 512                  # csrc/fps.cu
MAX_POINTS = 16 * _THREADS      # its largest per-thread register tile
_SMEM_LIMIT = 232448            # bytes of shared memory a block can use


def _check(points: torch.Tensor, n_samples: int) -> None:
    if points.ndim != 3:
        raise ValueError(f"fps takes points [B, N, C], got "
                         f"{tuple(points.shape)}")
    if points.shape[1] < 1 or n_samples < 1:
        raise ValueError(f"fps: need N >= 1 and n_samples >= 1, got "
                         f"N={points.shape[1]}, n_samples={n_samples}")


def fps_cuda(points: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Launch the FPS kernel: [B, N, 3] f32 -> [B, S] int64."""
    from repro_torch.kernels import _build
    _check(points, n_samples)
    b, n, c = points.shape
    if (not points.is_cuda or points.dtype != torch.float32
            or not points.is_contiguous()):
        raise ValueError(f"fps kernel needs a contiguous float32 CUDA "
                         f"tensor, got {points.dtype} on {points.device}")
    if c != 3:
        raise ValueError(f"fps kernel takes xyz (C = 3), got C = {c}")
    if n > MAX_POINTS or n * c * 4 > _SMEM_LIMIT:
        raise ValueError(f"fps kernel takes N <= {MAX_POINTS}, got {n}")
    out = torch.empty((b, n_samples), dtype=torch.int64,
                      device=points.device)
    if b == 0:
        return out
    stream = torch.cuda.current_stream(points.device).cuda_stream
    code = _build.launcher("fps")(points.data_ptr(), out.data_ptr(), b, n,
                                  n_samples, stream)
    _build.check("fps", code)
    fps_cuda.launches += 1
    return out


def fps(points: torch.Tensor, n_samples: int) -> torch.Tensor:
    """[B, N, C] -> [B, S] int64 farthest-point indices, starting at 0,
    ties to the lowest index."""
    if points.is_cuda:
        return fps_cuda(points.contiguous(), n_samples)
    if points.device.type == "cpu":
        _check(points, n_samples)
        return ref.fps_ref(points, n_samples)
    raise ValueError(f"fps: unsupported device {points.device}")


fps_cuda.launches = 0
