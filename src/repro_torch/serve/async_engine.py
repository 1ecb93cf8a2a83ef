"""Async point-cloud serving: futures, SLO-aware batching, double buffering.

The twin of ``repro.serve.async_engine``.  :class:`AsyncPointCloudEngine`
serves clouds that arrive one at a time over any
:class:`~repro_torch.api.build.FrozenPipeline`:

* ``submit(cloud)`` enqueues one request and returns a
  :class:`ServeFuture`, resolved when its dispatch completes (FIFO).
* A :class:`~repro_torch.serve.policy.BatchPolicy` (``PipelineSpec.
  policy`` / ``slo_ms``) decides on every ``pump()`` whether the queue is
  worth a fixed-shape dispatch now.
* Double buffering: a CUDA launch returns before the card finishes, so
  the engine enqueues batch N+1 (stack, pad, upload, launch) before it
  waits for batch N.  A ``torch.cuda.Event`` recorded after each dispatch
  says when it is done: a non-blocking ``pump(block=False)`` retires only
  what ``event.query()`` reports finished, and the retire waits with
  ``event.synchronize()``.  On the CPU the work is done when the call
  returns.  At most one dispatch is in flight.

LFSR contract: every dispatch starts from the engine's seed LFSR state.
Under ``spec.serving()`` semantics and one dispatch shape, a request's
logits are then bit for bit those of its cloud served alone (zero-padded
to ``max_batch``), whatever else shares its dispatch and whatever the
policy decided.  (The sync engine instead advances one state across
calls.)

Timing: ``stats.serve_s`` is the host time of the launches plus the
retire's wait, so a timed window always ends with the event's
synchronize; ``CostModelBatch.calibrate`` and the fleet's admission read
it.

Driving it::

    eng = AsyncPointCloudEngine.from_params(params, spec, max_batch=32)
    fut = eng.submit(cloud)
    eng.pump()        # policy check; maybe dispatch; retire finished work
    eng.flush()       # drain everything; all futures resolve
    fut.result()

or under asyncio: ``server = asyncio.create_task(eng.serve_loop())``,
``await eng.classify_async(cloud)``, then ``eng.close(); await server``.
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
import time
import warnings
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.api.build import FrozenPipeline, build
from repro_torch.serve import batching
from repro_torch.serve.batching import PointCloudStats
from repro_torch.serve.policy import BatchPolicy, make_policy
from repro_torch.serve.streaming import (AsyncStreamSession,
                                         require_streaming, tree_map)

__all__ = ["AsyncPointCloudEngine", "ServeFuture"]


class ServeFuture:
    """Completion handle for one submitted cloud.

    The engine (never a caller) resolves it with the request's logits row
    (on the pipeline's device).  ``t_submit`` / ``t_done`` come from the
    engine's clock, so ``latency_ms`` is exact on a virtual clock too.
    """

    __slots__ = ("request_id", "t_submit", "t_done", "_value", "_done",
                 "_callbacks")

    def __init__(self, request_id: int, t_submit: float):
        self.request_id = request_id
        self.t_submit = t_submit
        self.t_done: Optional[float] = None
        self._value = None
        self._done = False
        self._callbacks: List[Callable] = []

    def done(self) -> bool:
        return self._done

    def result(self) -> torch.Tensor:
        """The logits row; raises while pending (pump/flush the engine)."""
        if not self._done:
            raise RuntimeError(
                f"request {self.request_id} is still pending — drive the "
                f"engine (pump()/flush()/serve_loop) before result()")
        return self._value

    def add_done_callback(self, fn: Callable[["ServeFuture"], None]) -> None:
        """Call ``fn(self)`` on resolution (at once if already done).  A
        callback that raises is reported as a ``RuntimeWarning`` and does
        not strand the requests that share its dispatch."""
        if self._done:
            self._run_callback(fn)
        else:
            self._callbacks.append(fn)

    def _run_callback(self, fn: Callable) -> None:
        try:
            fn(self)
        except Exception as e:  # noqa: BLE001 — containment is the point
            warnings.warn(
                f"ServeFuture done-callback for request {self.request_id} "
                f"raised {type(e).__name__}: {e}", RuntimeWarning,
                stacklevel=2)

    @property
    def latency_ms(self) -> Optional[float]:
        """Submit-to-resolve latency on the engine clock (None if pending)."""
        if self.t_done is None:
            return None
        return (self.t_done - self.t_submit) * 1e3

    def _resolve(self, value: torch.Tensor, t_done: float) -> None:
        assert not self._done, "a request resolves exactly once"
        self._value = value
        self.t_done = t_done
        self._done = True
        callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            self._run_callback(fn)


@dataclasses.dataclass
class _Inflight:
    """One dispatched batch whose device work may still be running."""
    futures: List[ServeFuture]
    logits: torch.Tensor             # [max_batch, ...] on the device
    event: Optional[torch.cuda.Event]   # recorded after it; None on the CPU
    # per future (None for a plain request): ("hit", state, cache_row) or
    # ("miss", state, cloud)
    stream: List = dataclasses.field(default_factory=list)
    # the collect pass's cache of a cold dispatch on a streaming pipeline
    cache: object = None


class AsyncPointCloudEngine:
    """SLO-aware async serving over a frozen pipeline.

    Args:
      pipeline: a :class:`FrozenPipeline` built from a ``spec.serving()``
        spec (or use :meth:`from_params`); its device is the engine's.
      max_batch: the one dispatch shape; partial dispatches are
        zero-padded to it.
      policy: a :class:`BatchPolicy`, a ``POLICIES`` key, or None for the
        spec's ``policy`` / ``slo_ms`` / ``dispatch_ms``.
      seed: LFSR seed; every dispatch restarts from this state.
      clock: monotonic seconds for request stamps and the policy's wait
        (inject a virtual clock to drive it deterministically).
      calibrate_every: refit a calibratable policy (``"cost"``) every this
        many dispatches, from the window since the last fit; 0 disables.
    """

    def __init__(self, pipeline: FrozenPipeline, max_batch: int = 8,
                 policy=None, seed: int = 0,
                 clock: Callable[[], float] = time.monotonic,
                 calibrate_every: int = 64):
        if not isinstance(pipeline, FrozenPipeline):
            raise TypeError(
                "AsyncPointCloudEngine wraps a repro_torch FrozenPipeline; "
                "build one with repro_torch.api.build.build(spec, params) "
                "or use AsyncPointCloudEngine.from_params(params, spec)")
        self.pipeline = pipeline
        self.spec = pipeline.spec
        if not (self.spec.shared_urs and self.spec.per_sample_norm):
            # Dispatch invariance and pad lanes that cannot leak rest on
            # the serving batch semantics.
            raise ValueError(
                "AsyncPointCloudEngine needs a serving spec (shared_urs + "
                "per_sample_norm); build the pipeline from spec.serving()")
        self.cfg = pipeline.model_config
        self.device = pipeline.device
        self.max_batch = int(max_batch)
        batching.check_shard_batch(self.max_batch, self.spec.data_shards)
        if policy is None:
            policy = self.spec.policy
        self.policy: BatchPolicy = make_policy(
            policy, slo_ms=self.spec.slo_ms,
            dispatch_ms=self.spec.dispatch_ms)
        self.stats = PointCloudStats()
        # per-request latencies in resolve order, the recent window only
        self.latencies_ms: collections.deque = collections.deque(
            maxlen=10_000)
        self._clock = clock
        if not isinstance(calibrate_every, int) or calibrate_every < 0:
            raise ValueError(f"calibrate_every must be a non-negative "
                             f"int, got {calibrate_every!r}")
        self.calibrate_every = calibrate_every
        # (batches, serve_s) at the last calibration: the sliding window
        self._cal_origin = (0, 0.0)
        self._lfsr0 = pipeline.seed_state(seed, self.max_batch)
        self._queue: collections.deque = collections.deque()
        self._inflight: Optional[_Inflight] = None
        self._seq = 0
        self._closed = False

    @classmethod
    def from_params(cls, params, spec, *, device=None, mesh=None,
                    **kwargs) -> "AsyncPointCloudEngine":
        """Validate ``spec``, build its pipeline on ``device`` (default
        ``cuda``; raises without a GPU), or over ``mesh`` for a sharded
        spec (see ``build``), and wrap it."""
        spec.validate()
        return cls(build(spec, params, device=device, mesh=mesh), **kwargs)

    # ------------------------------------------------------ sans-IO ----

    def submit(self, points) -> ServeFuture:
        """Enqueue one [N, 3] cloud; returns its future (FIFO service)."""
        if self._closed:
            raise RuntimeError("engine is closed")
        cloud = np.asarray(points, np.float32)
        if cloud.shape != (self.cfg.n_points, 3):
            raise ValueError(
                f"submit() takes one [N={self.cfg.n_points}, 3] cloud; "
                f"got shape {cloud.shape}")
        fut = ServeFuture(self._seq, self._clock())
        self._seq += 1
        self._queue.append((cloud, fut, None))
        return fut

    def _submit_stream(self, cloud, state, hit: bool) -> ServeFuture:
        """The submit path of :class:`~repro_torch.serve.streaming.
        AsyncStreamSession` (the frame is checked there).  A hit keeps
        the session's cache row as it is now, so a later ``reset()``
        cannot strand a queued frame."""
        if self._closed:
            raise RuntimeError("engine is closed")
        fut = ServeFuture(self._seq, self._clock())
        self._seq += 1
        info = ("hit", state, state.cache) if hit else ("miss", state, cloud)
        self._queue.append((cloud, fut, info))
        return fut

    def open_stream(self, *, max_age=None):
        """An :class:`~repro_torch.serve.streaming.AsyncStreamSession`
        over this engine's queue: its frames share dispatches with plain
        requests and other sessions' frames (a cache-replay dispatch and
        a recompute dispatch never mix).  Needs a ``stream=True`` spec."""
        require_streaming(self.pipeline)
        return AsyncStreamSession(
            self._submit_stream, n_points=self.cfg.n_points,
            threshold=self.spec.stream_drift_threshold, max_age=max_age)

    def pump(self, block: bool = True) -> int:
        """One scheduler turn; returns how many requests were dispatched.

        On a dispatch the previous batch is retired after the new one is
        enqueued (the double buffer); on an idle turn the batch in flight
        is retired.  ``block=False`` retires it only if its event reports
        it finished, so a cooperative loop never stalls on the card.
        """
        self._maybe_recalibrate()
        depth = len(self._queue)
        oldest_wait_ms = 0.0
        if depth:
            oldest_wait_ms = (self._clock()
                              - self._queue[0][1].t_submit) * 1e3
        n = self.policy.decide(depth=depth, oldest_wait_ms=oldest_wait_ms,
                               max_batch=self.max_batch)
        n = max(0, min(n, depth, self.max_batch))
        if n == 0:
            self._retire(wait=block)
            return 0
        self._dispatch(n)
        return n

    def flush(self) -> None:
        """Drain the queue (the policy bypassed) and resolve every future."""
        while self._queue:
            self._dispatch(min(len(self._queue), self.max_batch))
        self._retire()

    @property
    def depth(self) -> int:
        """Queued (not yet dispatched) requests."""
        return len(self._queue)

    @property
    def pending(self) -> int:
        """Requests not yet resolved: queued and in flight."""
        inflight = len(self._inflight.futures) if self._inflight else 0
        return len(self._queue) + inflight

    def reset_stats(self) -> None:
        """A fresh measurement window: ``stats``, the latency log and the
        recalibration window."""
        self.stats.reset()
        self.latencies_ms.clear()
        self._cal_origin = (0, 0.0)

    def calibrate_policy(self) -> bool:
        """Refit a calibratable policy from the cumulative stats (and
        restart the periodic window).  Returns True when the policy took
        a calibration."""
        calibrate = getattr(self.policy, "calibrate", None)
        if calibrate is None or self.stats.batches == 0:
            return False
        calibrate(self.stats, self.max_batch,
                  data_shards=self.spec.data_shards)
        self._cal_origin = (self.stats.batches, self.stats.serve_s)
        return True

    def _maybe_recalibrate(self) -> None:
        """Refit from exactly the last ``calibrate_every`` dispatches."""
        if not self.calibrate_every:
            return
        calibrate = getattr(self.policy, "calibrate", None)
        if calibrate is None:
            return
        batches0, serve_s0 = self._cal_origin
        window_batches = self.stats.batches - batches0
        if window_batches < self.calibrate_every:
            return
        window = PointCloudStats()
        window.batches = window_batches
        window.serve_s = self.stats.serve_s - serve_s0
        calibrate(window, self.max_batch,
                  data_shards=self.spec.data_shards)
        self._cal_origin = (self.stats.batches, self.stats.serve_s)

    def warmup(self) -> float:
        """Build the kernels and run the one dispatch shape (both stream
        passes on a streaming pipeline) ahead of traffic; the queue and
        the LFSR seed state stay as they are.  Returns seconds."""
        dummy = torch.zeros((self.max_batch, self.cfg.n_points, 3),
                            device=self.device)
        t0 = time.perf_counter()
        if self.pipeline.streaming:
            _, _, cache = self.pipeline.infer_collect(dummy,
                                                      self._lfsr0.clone())
            self.pipeline.infer_cached(dummy, self._lfsr0.clone(), cache)
        else:
            self.pipeline.infer(dummy, self._lfsr0.clone())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self.stats.compile_s += dt
        return dt

    def describe(self) -> str:
        return (f"{self.pipeline.describe()}\n"
                f"  max_batch : {self.max_batch}\n"
                f"  policy    : {self.policy.describe()}")

    # ------------------------------------------------ dispatch core ----

    def _upload(self, batch: torch.Tensor) -> torch.Tensor:
        """The host batch onto the device; through pinned memory on the
        card, so the copy does not wait for the dispatch in flight."""
        if self.device.type != "cuda":
            return batch.to(self.device)
        return batch.pin_memory().to(self.device, non_blocking=True)

    def _dispatch(self, n: int) -> None:
        t_host = time.perf_counter()
        streaming = self.pipeline.streaming
        if streaming:
            # One dispatch is all stream hits (infer_cached) or none of
            # them (infer_collect: plain requests and stream misses):
            # take the longest run of one kind; the rest stays queued.
            def is_hit(entry):
                return entry[2] is not None and entry[2][0] == "hit"
            lead = is_hit(self._queue[0])
            run = 1
            while run < n and is_hit(self._queue[run]) == lead:
                run += 1
            n = run
        taken = [self._queue.popleft() for _ in range(n)]
        chunk = batching.stack_requests([c for c, _, _ in taken],
                                        self.cfg.n_points)
        batch, pad = batching.pad_to_batch(chunk, self.max_batch)
        batch = self._upload(batch)
        stream = [s for _, _, s in taken]
        hit_run = streaming and stream[0] is not None \
            and stream[0][0] == "hit"
        if hit_run:
            # the sessions' cache rows, stacked; pad lanes replay index 0
            # everywhere (valid, computed, never returned)
            rows = [s[2] for s in stream]
            rows += [tree_map(torch.zeros_like, rows[0])] * pad
            cache_in = tree_map(lambda *r: torch.stack(r), *rows)
        self.stats.host_s += time.perf_counter() - t_host

        # Enqueue batch N+1, then retire batch N.  Every dispatch restarts
        # from the seed state; the advanced state is dropped.
        t0 = time.perf_counter()
        cache_out = None
        if hit_run:
            logits, _ = self.pipeline.infer_cached(
                batch, self._lfsr0.clone(), cache_in)
        elif streaming:
            # collect-pass logits are infer's bit for bit; only the miss
            # sessions read their cache row back, at retire
            logits, _, cache_out = self.pipeline.infer_collect(
                batch, self._lfsr0.clone())
        else:
            logits, _ = self.pipeline.infer(batch, self._lfsr0.clone())
        event = None
        if self.device.type == "cuda":
            # after the logits' gather, on the first device of a sharded
            # pipeline's mesh: the gather waits for every shard
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        self.stats.serve_s += time.perf_counter() - t0
        nxt = _Inflight([f for _, f, _ in taken], logits, event, stream,
                        cache_out)
        self._retire()
        self._inflight = nxt
        self.stats.batches += 1
        self.stats.padded += pad
        self.stats.requests += n

    def _retire(self, wait: bool = True) -> None:
        inflight = self._inflight
        if inflight is None:
            return
        if not wait and inflight.event is not None \
                and not inflight.event.query():
            return                       # the card is still busy
        t0 = time.perf_counter()
        if inflight.event is not None:
            inflight.event.synchronize()
        self.stats.serve_s += time.perf_counter() - t0
        self._inflight = None
        now = self._clock()
        for i, fut in enumerate(inflight.futures):
            fut._resolve(inflight.logits[i], now)
            self.latencies_ms.append(fut.latency_ms)
            info = inflight.stream[i]
            if (info is not None and info[0] == "miss"
                    and inflight.cache is not None):
                _, state, cloud = info
                state.refresh(tree_map(lambda a, i=i: a[i], inflight.cache),
                              cloud)

    # ------------------------------------------------ asyncio shell ----

    async def classify_async(self, points) -> torch.Tensor:
        """Submit one cloud and await its logits (run :meth:`serve_loop`
        as a background task to pump the engine)."""
        loop = asyncio.get_running_loop()
        afut = loop.create_future()

        def on_done(fut: ServeFuture) -> None:
            def settle() -> None:
                if not afut.done():
                    afut.set_result(fut.result())
            loop.call_soon_threadsafe(settle)

        self.submit(points).add_done_callback(on_done)
        return await afut

    async def serve_loop(self, tick_s: float = 0.001) -> None:
        """Pump every ``tick_s`` (non-blocking) until :meth:`close`, then
        flush.  The only place the engine sleeps."""
        while not self._closed:
            self.pump(block=False)
            await asyncio.sleep(tick_s)
        self.flush()

    def close(self) -> None:
        """Stop accepting requests; a running serve_loop flushes and
        exits (call ``flush()`` when driving the engine directly)."""
        self._closed = True
