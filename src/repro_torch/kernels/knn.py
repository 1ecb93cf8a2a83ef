"""kNN selection: the CUDA kernel ``csrc/knn.cu`` and its wrapper.

The port of ``repro.kernels.knn.knn_pallas``, batched over lanes: one
launch serves a whole dispatch.  :func:`knn` launches the kernel for
CUDA tensors, runs :func:`repro_torch.kernels.ref.knn_ref` for CPU
tensors, and raises on anything else.  ``knn_cuda.launches`` counts
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

MAX_CHANNELS = 8
_SMEM_LIMIT = 232448            # bytes of shared memory a block can use
_QUERIES_PER_BLOCK = 8          # csrc/knn.cu


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


def knn_cuda(samples: torch.Tensor, points: torch.Tensor, k: int
             ) -> torch.Tensor:
    """Launch the kNN kernel: [B, S, C], [B, N, C] f32 -> [B, S, k] int64."""
    from repro_torch.kernels import _build
    _check(samples, points, k)
    b, s, c = samples.shape
    n = points.shape[1]
    for name, t in (("samples", samples), ("points", points)):
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"knn kernel needs a contiguous float32 CUDA "
                             f"{name} tensor, got {t.dtype} on {t.device}")
    if points.device != samples.device:
        raise ValueError("knn: samples and points on different devices")
    if c > MAX_CHANNELS:
        raise ValueError(f"knn kernel takes C <= {MAX_CHANNELS}, got {c}")
    smem = (n * c + n + _QUERIES_PER_BLOCK * n) * 4
    if smem > _SMEM_LIMIT:
        raise ValueError(f"knn kernel: N={n} needs {smem} bytes of shared "
                         f"memory, more than {_SMEM_LIMIT}")
    out = torch.empty((b, s, k), dtype=torch.int64, device=samples.device)
    if b * s == 0:
        return out
    stream = torch.cuda.current_stream(samples.device).cuda_stream
    code = _build.launcher("knn")(samples.data_ptr(), points.data_ptr(),
                                  out.data_ptr(), b, s, n, c, k, stream)
    _build.check("knn", code)
    knn_cuda.launches += 1
    return out


def knn(samples: torch.Tensor, points: torch.Tensor, k: int) -> torch.Tensor:
    """[B, S, C], [B, N, C] -> [B, S, k] int64 nearest-neighbour indices,
    ascending distance, ties to the lowest index."""
    if samples.is_cuda:
        return knn_cuda(samples.contiguous(), points.contiguous(), k)
    if samples.device.type == "cpu" and points.device.type == "cpu":
        _check(samples, points, k)
        return ref.knn_ref(samples, points, k)
    raise ValueError(f"knn: unsupported devices {samples.device} / "
                     f"{points.device}")


knn_cuda.launches = 0
