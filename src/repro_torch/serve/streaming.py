"""Streaming LiDAR serving: per-stream temporal caches over the mapping ops.

The twin of ``repro.serve.streaming``.  Consecutive frames of one stream
are small rigid motions of each other, so the mapping results (FPS
indices, kNN or ball neighbour lists, the seg head's 1-NN index) barely
change while the arithmetic must rerun on each frame's own points.  A
:class:`StreamSession` keys a cache of mapping results off the frame's
drift (its largest point displacement from the cached key frame) and
replays it while the drift stays within ``spec.stream_drift_threshold``;
a larger drift, an age-based eviction or :meth:`StreamSession.reset`
takes the full recompute path.  A hit launches no mapping kernel.

Contract: every frame's logits equal, bit for bit, those of the
stateless reference :func:`replay_reference`: a miss is the plain cold
pass, a hit is the key frame's cache recomputed from scratch and
replayed.  URS still runs on a hit (its ``advances_state``), and every
frame's dispatch restarts from the seed LFSR state, so a frame's result
depends neither on the dispatch nor on the frames before it.

Transports::

    pipe = build(spec.replace(stream=True,
                              stream_drift_threshold=0.05).serving(), params)
    sess = StreamSession(pipe)                  # direct, blocking
    logits = sess.infer(frame)                  # [n_classes] / [N, C]
    sess = sync_engine.open_stream()            # the same, engine's seed
    sess = async_engine.open_stream()           # AsyncStreamSession
    fut = sess.submit(frame); async_engine.pump()
    sess = fleet.open_stream("lidar")           # routed and admitted

The drift and the cache decisions are host code (numpy), as in the JAX
package; the caches are tensors on the pipeline's device (a sharded
pipeline's first mesh device: each dispatch sends a shard's cache rows
to that shard's device).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["StreamStats", "StreamSession", "AsyncStreamSession",
           "replay_reference", "require_streaming"]


@dataclasses.dataclass
class StreamStats:
    """Per-session cache accounting: ``frames == hits + misses``;
    ``resets`` counts :meth:`StreamSession.reset` calls, ``evictions`` the
    misses forced by ``max_age``."""
    frames: int = 0
    hits: int = 0
    misses: int = 0
    resets: int = 0
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / self.frames if self.frames else 0.0


def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of equally shaped dict/tuple trees
    (stream caches)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def _check_frame(frame, n_points: int) -> np.ndarray:
    arr = np.asarray(frame, np.float32)
    if arr.shape != (n_points, 3):
        raise ValueError(
            f"a stream frame is one [N={n_points}, 3] cloud; got shape "
            f"{arr.shape}")
    return arr


class _CacheState:
    """The decision and cache core every transport shares.

    Holds the key frame's points (on the host, for the drift), the
    per-lane cache row (batch dimension stripped) and the hits since the
    last refresh.  ``decide`` is pure, so a shed submission leaves the
    session as it was; ``commit`` counts the decision and ``refresh``
    installs a new key frame and cache.
    """

    def __init__(self, threshold: float, max_age: Optional[int] = None):
        if not threshold >= 0:
            raise ValueError(f"drift threshold must be >= 0, "
                             f"got {threshold!r}")
        if max_age is not None and (not isinstance(max_age, int)
                                    or max_age < 1):
            raise ValueError(f"max_age must be None or a positive int, "
                             f"got {max_age!r}")
        self.threshold = threshold
        self.max_age = max_age
        self.key_xyz: Optional[np.ndarray] = None
        self.cache = None            # per-lane row, batch dim stripped
        self.age = 0                 # hits served since the last refresh
        self.stats = StreamStats()

    def drift(self, frame: np.ndarray) -> float:
        """Largest point displacement from the key frame (inf without a
        live cache)."""
        if self.key_xyz is None:
            return float("inf")
        return float(np.max(np.linalg.norm(frame - self.key_xyz, axis=-1)))

    def decide(self, frame: np.ndarray) -> str:
        """``"hit"``, ``"miss"`` or ``"evict"`` for this frame (pure)."""
        if self.cache is None:
            return "miss"
        if self.max_age is not None and self.age >= self.max_age:
            return "evict"
        if self.drift(frame) > self.threshold:
            return "miss"
        return "hit"

    def commit(self, decision: str) -> None:
        self.stats.frames += 1
        if decision == "hit":
            self.stats.hits += 1
            self.age += 1
        else:
            self.stats.misses += 1
            if decision == "evict":
                self.stats.evictions += 1

    def refresh(self, cache_row, key_xyz: np.ndarray) -> None:
        self.cache = cache_row
        self.key_xyz = key_xyz
        self.age = 0

    def reset(self) -> None:
        self.cache = None
        self.key_xyz = None
        self.age = 0
        self.stats.resets += 1


def require_streaming(pipeline) -> None:
    """RPA030: a stream session needs a ``stream=True`` pipeline."""
    if not getattr(pipeline, "streaming", False):
        raise ValueError(
            "RPA030: stream sessions need a streaming pipeline — build one "
            "from a spec with stream=True (e.g. spec.replace(stream=True, "
            "stream_drift_threshold=0.05))")


def _lanes(frame: np.ndarray, batch: int) -> torch.Tensor:
    """The frame repeated over ``batch`` lanes, as a CPU tensor."""
    return torch.from_numpy(np.repeat(frame[None], batch, axis=0))


class StreamSession:
    """Blocking per-stream session over a streaming
    :class:`~repro_torch.api.build.FrozenPipeline` (the direct transport;
    ``PointCloudEngine.open_stream`` gives one with the engine's seed).

    Args:
      pipeline: a ``stream=True`` pipeline (``pipeline.streaming``).
      seed: LFSR seed; every frame's dispatch restarts from it.
      max_age: evict the cache after this many hits in a row (None: drift
        alone decides).
      batch: dispatch width: the frame is repeated over the lanes and lane
        0 returned, the same bits at any width.  Defaults to
        ``spec.data_shards``, the smallest batch a sharded dispatch
        splits (one lane a shard).
    """

    def __init__(self, pipeline, *, seed: int = 0,
                 max_age: Optional[int] = None,
                 batch: Optional[int] = None):
        require_streaming(pipeline)
        spec = pipeline.spec
        if batch is None:
            batch = max(1, spec.data_shards)
        if batch < 1 or batch % max(1, spec.data_shards):
            raise ValueError(
                f"stream batch must be a positive multiple of "
                f"data_shards={spec.data_shards}, got {batch}")
        self.pipeline = pipeline
        self._batch = int(batch)
        self._lfsr0 = pipeline.seed_state(seed, self._batch)
        self._state = _CacheState(spec.stream_drift_threshold, max_age)
        # A miss repeats the frame over every lane, so the collect pass's
        # whole output is the cache for a hit dispatch, kept on the device.
        self._cache_batched = None

    @property
    def stats(self) -> StreamStats:
        return self._state.stats

    def drift(self, frame) -> float:
        """The drift of ``frame`` from the current key frame."""
        frame = _check_frame(frame, self.pipeline.model_config.n_points)
        return self._state.drift(frame)

    def reset(self) -> None:
        """Drop the cache: the next frame takes the full recompute path."""
        self._state.reset()
        self._cache_batched = None

    def infer(self, frame) -> torch.Tensor:
        """Serve one frame: its logits row ([n_classes], or [n_points,
        n_classes] for the seg head) on the pipeline's device."""
        frame = _check_frame(frame, self.pipeline.model_config.n_points)
        decision = self._state.decide(frame)
        self._state.commit(decision)
        pts = _lanes(frame, self._batch)
        if decision == "hit":
            logits, _ = self.pipeline.infer_cached(
                pts, self._lfsr0.clone(), self._cache_batched)
        else:
            logits, _, cache = self.pipeline.infer_collect(
                pts, self._lfsr0.clone())
            self._state.refresh(tree_map(lambda a: a[0], cache), frame)
            self._cache_batched = cache
        return logits[0]


class AsyncStreamSession:
    """Future-returning per-stream session over the async engine or the
    fleet (their ``open_stream`` makes it; frames go through the engine's
    queue).

    The cache decision is taken at :meth:`submit` against the current key
    frame; a miss's refresh lands when its dispatch retires.  So one frame
    at a time may be unresolved: pump the engine between frames
    (concurrent sessions fill the lanes).  A shed submission (the fleet's
    ``Overloaded``) leaves the session as it was.
    """

    def __init__(self, submit_fn: Callable, *, n_points: int,
                 threshold: float, max_age: Optional[int] = None):
        self._submit_fn = submit_fn
        self._n_points = n_points
        self._state = _CacheState(threshold, max_age)
        self._pending = None

    @property
    def stats(self) -> StreamStats:
        return self._state.stats

    def drift(self, frame) -> float:
        """The drift of ``frame`` from the current key frame."""
        return self._state.drift(_check_frame(frame, self._n_points))

    def reset(self) -> None:
        """Drop the cache: the next frame takes the full recompute path."""
        self._state.reset()

    def submit(self, frame):
        """Enqueue one frame; returns its
        :class:`~repro_torch.serve.async_engine.ServeFuture`."""
        if self._pending is not None and not self._pending.done():
            raise RuntimeError(
                "this stream session already has a frame in flight — pump "
                "or flush the engine until it resolves before submitting "
                "the next frame (frame order is the cache recurrence; "
                "concurrent sessions, not concurrent frames, fill lanes)")
        frame = _check_frame(frame, self._n_points)
        decision = self._state.decide(frame)
        # may raise (the fleet's Overloaded): commit after
        fut = self._submit_fn(frame, self._state, decision == "hit")
        self._state.commit(decision)
        self._pending = fut
        return fut


def replay_reference(pipeline, frames, *, seed: int = 0,
                     max_age: Optional[int] = None, resets=()):
    """The stateless reference of the streaming contract.

    Replays the sessions' decision recurrence over ``frames`` with no
    carried device state: a hit recomputes its key frame's cache from
    scratch (``infer_collect``) and replays it, a miss runs the plain
    cold pass (``infer``).  ``resets`` are the frame indices before which
    a session's ``reset()`` runs.  Returns the per-frame logits rows.
    """
    require_streaming(pipeline)
    spec = pipeline.spec
    n_points = pipeline.model_config.n_points
    batch = max(1, spec.data_shards)
    lfsr0 = pipeline.seed_state(seed, batch)
    resets = set(resets)
    frames = [_check_frame(f, n_points) for f in frames]
    out = []
    key_j: Optional[int] = None
    age = 0
    for i, frame in enumerate(frames):
        if i in resets:
            key_j = None
        if key_j is None:
            decision = "miss"
        elif max_age is not None and age >= max_age:
            decision = "miss"
        elif float(np.max(np.linalg.norm(frame - frames[key_j], axis=-1))
                   ) > spec.stream_drift_threshold:
            decision = "miss"
        else:
            decision = "hit"
        pts = _lanes(frame, batch)
        if decision == "hit":
            _, _, cache = pipeline.infer_collect(_lanes(frames[key_j], batch),
                                                 lfsr0.clone())
            logits, _ = pipeline.infer_cached(pts, lfsr0.clone(), cache)
            age += 1
        else:
            logits, _ = pipeline.infer(pts, lfsr0.clone())
            key_j, age = i, 0
        out.append(logits[0])
    return out
