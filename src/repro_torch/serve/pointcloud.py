"""Batched point-cloud inference engine (the HLS4PC deployment path).

The twin of ``repro.serve.pointcloud.PointCloudEngine``: a PipelineSpec
is frozen once by ``repro_torch.api.build`` and the engine drains a
ragged request queue in fixed-shape ``max_batch`` chunks, zero-padding
the last.  The URS sampler runs off a persistent LFSR state held by the
engine, so results are queue-order invariant and the state advances
deterministically across calls.
"""
from __future__ import annotations

import time
from typing import Dict, List

import torch

from repro_torch.api.build import build, resolve_device
from repro_torch.api.spec import PipelineSpec
from repro_torch.serve import batching
from repro_torch.serve.batching import PointCloudStats

__all__ = ["PointCloudEngine", "PointCloudStats"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PointCloudEngine:
    """Fixed-shape batched classifier over a frozen pipeline.

    Args:
      params: parameter tree (BN running stats populated, or frozen).
      spec: the variant to freeze and serve, typically
        ``lite_spec(...).serving().replace(backend="cuda")``.
      max_batch: the one dispatch batch; ragged queues are chunked and
        padded to it.
      seed: LFSR seed (the paper's "same starting states").
      device: ``None`` serves on ``cuda`` (raising without a GPU);
        ``"cpu"`` runs the plain versions.
    """

    def __init__(self, params: Dict, spec: PipelineSpec, max_batch: int = 8,
                 seed: int = 0, device=None):
        if not isinstance(spec, PipelineSpec):
            raise TypeError(f"PointCloudEngine takes a repro_torch "
                            f"PipelineSpec, got {type(spec).__name__}")
        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        self.pipeline = build(spec, params, device=self.device)
        self.spec = self.pipeline.spec
        self.cfg = self.pipeline.model_config
        self.params = self.pipeline.params
        self.stats = PointCloudStats()
        self._seed = int(seed)
        # One LFSR stream per dispatch lane.
        self._lfsr = self.pipeline.seed_state(seed, self.max_batch)

    def warmup(self) -> float:
        """Build the kernels and run the one dispatch shape once, ahead of
        traffic (does not consume LFSR state).  Returns seconds."""
        dummy = torch.zeros((self.max_batch, self.cfg.n_points, 3),
                            device=self.device)
        t0 = time.perf_counter()
        self.pipeline.infer(dummy, self._lfsr.clone())
        _sync(self.device)
        dt = time.perf_counter() - t0
        self.stats.compile_s += dt
        return dt

    def _chunk_queue(self, pts: torch.Tensor) -> List[torch.Tensor]:
        chunks = []
        for chunk in batching.split_queue(pts, self.max_batch):
            chunk, pad = batching.pad_to_batch(chunk, self.max_batch)
            self.stats.padded += pad
            chunks.append(chunk)
        return chunks

    def classify(self, points) -> torch.Tensor:
        """Classify a ragged queue: [R, N, 3] (or a list of [N, 3] clouds)
        -> logits [R, n_classes] (the seg head: [R, n_points, n_classes])
        on the engine's device; pad lanes are computed but never returned.

        ``stats.serve_s`` times the dispatch loop up to a device sync;
        queue conversion, upload and padding land in ``stats.host_s``.
        """
        t_host = time.perf_counter()
        pts = batching.as_point_queue(points, self.cfg.n_points, self.device)
        if pts.shape[0] == 0:
            per_point = ((self.cfg.n_points,) if self.cfg.head == "seg"
                         else ())
            return torch.zeros((0, *per_point, self.cfg.n_classes),
                               device=self.device)
        r = pts.shape[0]
        chunks = self._chunk_queue(pts)
        self.stats.host_s += time.perf_counter() - t_host

        t0 = time.perf_counter()
        out = []
        for j, chunk in enumerate(chunks):
            logits, self._lfsr = self.pipeline.infer(chunk, self._lfsr)
            out.append(logits[:min(self.max_batch, r - j * self.max_batch)])
            self.stats.batches += 1
        _sync(self.device)
        self.stats.serve_s += time.perf_counter() - t0
        self.stats.requests += r
        return torch.cat(out, dim=0)

    def predict(self, points) -> torch.Tensor:
        """Top-1 class ids for a ragged queue: [R], or [R, n_points] for
        the seg head."""
        return torch.argmax(self.classify(points), dim=-1)

    def describe(self) -> str:
        """The frozen pipeline's description plus serving shape."""
        return f"{self.pipeline.describe()}\n  max_batch : {self.max_batch}"

    @property
    def lfsr_state(self) -> torch.Tensor:
        """Persistent URS sampler state (a copy)."""
        return self._lfsr.clone()
