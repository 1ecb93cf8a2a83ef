"""Pad/dispatch/unpad core of the point-cloud serving engine.

The twin of ``repro.serve.batching``: queue normalization, ``max_batch``
chunking, zero pad-to-batch, request stacking and the stats schema that
the sync and async engines share.  Pad lanes are
computed but never returned, and under ``spec.serving()`` semantics they
cannot leak into a real lane's result.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class PointCloudStats:
    """Serving stats: requests, dispatches, pad lanes and the time split
    between device dispatch (``serve_s``) and host queue prep
    (``host_s``)."""
    requests: int = 0          # real samples served
    batches: int = 0           # fixed-shape dispatches
    padded: int = 0            # dummy pad samples computed
    compile_s: float = 0.0     # time spent in warmup (kernel build + first run)
    serve_s: float = 0.0       # dispatch loop, ended by a device sync
    host_s: float = 0.0        # host-side padding / conversion / upload

    @property
    def samples_per_s(self) -> float:
        """Dispatch throughput; host-side queue prep is in ``host_s``."""
        return self.requests / max(self.serve_s, 1e-9)

    def reset(self) -> None:
        """Zero every counter and timer."""
        fresh = PointCloudStats()
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(fresh, f.name))


def as_point_queue(points, n_points: int, device=None) -> torch.Tensor:
    """Normalize a classify() input to a float32 [R, N, 3] queue on
    ``device``.

    Accepts a [R, N, 3] tensor or array, one [N, 3] cloud, a list of
    clouds, or an empty input.  Malformed input raises ``ValueError``
    naming the expected and actual shapes.
    """
    if isinstance(points, torch.Tensor):
        pts = points.to(device=device, dtype=torch.float32)
    else:
        try:
            arr = np.asarray(points, np.float32)
        except (ValueError, TypeError):
            shapes = sorted({str(np.shape(c)) for c in points})
            raise ValueError(
                f"classify() takes [N={n_points}, 3] clouds of one shape; "
                f"got a ragged request list with shapes "
                f"[{', '.join(shapes)}]") from None
        pts = torch.from_numpy(arr).to(device)
    if pts.numel() == 0:
        return pts.reshape(0, n_points, 3)
    if pts.ndim == 2:
        pts = pts[None]
    if pts.ndim != 3 or tuple(pts.shape[1:]) != (n_points, 3):
        raise ValueError(f"engine is fixed-shape: expected [R, N={n_points}, "
                         f"3] (or one [N, 3] cloud), got {tuple(pts.shape)}")
    return pts


def check_shard_batch(max_batch: int, data_shards: int) -> None:
    """Reject a dispatch shape that ``data_shards`` devices cannot split
    evenly, at engine construction, before any mesh is made (the sharded
    dispatch, ``repro_torch.serve.sharding``, splits every fixed-shape
    dispatch into ``max_batch // data_shards`` lanes a device)."""
    if max_batch % data_shards:
        raise ValueError(
            f"data_shards={data_shards} must divide max_batch evenly: got "
            f"max_batch={max_batch} (every fixed-shape dispatch is split "
            f"across the devices)")


def split_queue(pts: torch.Tensor, max_batch: int) -> Iterator[torch.Tensor]:
    """Split a [R, N, 3] queue into <= ``max_batch`` chunks, in order."""
    for i in range(0, pts.shape[0], max_batch):
        yield pts[i:i + max_batch]


def pad_to_batch(chunk: torch.Tensor, max_batch: int
                 ) -> Tuple[torch.Tensor, int]:
    """Zero-pad a [r <= max_batch, N, 3] chunk to the one dispatch shape.

    Returns ``(padded [max_batch, N, 3], n_pad)``.
    """
    r, n = chunk.shape[0], chunk.shape[1]
    pad = max_batch - r
    if pad < 0:
        raise ValueError(f"chunk of {r} requests exceeds the fixed dispatch "
                         f"shape max_batch={max_batch}")
    if pad:
        chunk = torch.cat([chunk, chunk.new_zeros((pad, n, 3))], dim=0)
    return chunk, pad


def stack_requests(clouds: Sequence, n_points: int) -> torch.Tensor:
    """Stack [N, 3] request clouds into a float32 [r, N, 3] CPU tensor.

    Every cloud is shape-checked first, so a ragged request list raises a
    ``ValueError`` naming the offending requests.
    """
    arrs = [np.asarray(c, np.float32) for c in clouds]
    bad = [(i, a.shape) for i, a in enumerate(arrs)
           if a.shape != (n_points, 3)]
    if bad:
        raise ValueError(
            f"requests must be [N={n_points}, 3] clouds; got "
            + "; ".join(f"request {i}: shape {s}" for i, s in bad[:4])
            + (f" (+{len(bad) - 4} more)" if len(bad) > 4 else ""))
    return torch.from_numpy(np.stack(arrs, axis=0))
