"""SLO-aware batching policies for the async serving engine.

The twin of ``repro.serve.policy``.  A :class:`BatchPolicy` decides,
from the queue's state alone, how many requests are worth a fixed-shape
dispatch now.  Policies live in the :data:`POLICIES` registry;
``PipelineSpec.policy`` names one and ``slo_ms`` / ``dispatch_ms``
parametrize it::

    from repro_torch.serve.policy import BatchPolicy, register_policy

    @register_policy("my-policy")
    class MyPolicy(BatchPolicy):
        def decide(self, depth, oldest_wait_ms, max_batch): ...

``decide`` is a pure function of its arguments: the engine derives
``oldest_wait_ms`` from its injectable clock, so a virtual clock drives
the policies exactly.  This is host code; every decision is the JAX
package's.
"""
from __future__ import annotations

import inspect
import warnings

from repro_torch.api.registry import Registry

POLICIES = Registry("policy")
register_policy = POLICIES.register


def _warn(code: str, message: str, stacklevel: int = 3) -> None:
    """A soft misconfiguration, led by its ``repro.analysis`` code (the
    repo's pytest settings turn ``RPAxxx`` warnings into errors)."""
    warnings.warn(f"{code}: {message}", UserWarning, stacklevel=stacklevel)


class BatchPolicy:
    """Decides how many queued requests to dispatch.

    Every policy takes ``slo_ms`` (the per-request latency objective) and
    ``dispatch_ms`` (the estimated service time of one dispatch), even if
    it ignores them, so the engine can make any registry entry from the
    spec's fields.
    """

    def __init__(self, slo_ms: float = 0.0, dispatch_ms: float = 0.0):
        self.slo_ms = float(slo_ms)
        self.dispatch_ms = float(dispatch_ms)

    def decide(self, depth: int, oldest_wait_ms: float,
               max_batch: int) -> int:
        """Dispatch size for this queue state (0 = keep waiting).

        ``depth`` counts queued requests, ``oldest_wait_ms`` is the wait
        of the head of the line, ``max_batch`` the engine's dispatch
        shape (the engine clamps the answer to ``min(depth, max_batch)``).
        """
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__


@register_policy("fixed")
class FixedBatch(BatchPolicy):
    """Throughput-greedy: dispatch full batches only; a partial tail waits
    for ``flush()`` or more arrivals."""

    def decide(self, depth: int, oldest_wait_ms: float,
               max_batch: int) -> int:
        return max_batch if depth >= max_batch else 0

    def describe(self) -> str:
        return "FixedBatch(full batches only)"


@register_policy("deadline")
class DeadlineBatch(BatchPolicy):
    """Fill up, but never break the deadline: a full batch the moment the
    queue holds one; else wait until the head of the line has waited
    ``slo_ms - dispatch_ms``, then dispatch the partial batch.
    ``slo_ms = 0`` dispatches any non-empty queue at once.  A reservation
    at or above a positive SLO leaves no wait at all, which is almost
    always a misconfiguration, so it warns (RPA103).
    """

    def __init__(self, slo_ms: float = 50.0, dispatch_ms: float = 0.0):
        super().__init__(slo_ms, dispatch_ms)
        if self.slo_ms > 0 and self.dispatch_ms >= self.slo_ms:
            _warn("RPA103",
                  f"DeadlineBatch: dispatch_ms={self.dispatch_ms:g} "
                  f"consumes the whole slo_ms={self.slo_ms:g} budget — the "
                  f"policy collapses into dispatch-on-arrival (every pump "
                  f"with a non-empty queue dispatches)")

    def decide(self, depth: int, oldest_wait_ms: float,
               max_batch: int) -> int:
        if depth >= max_batch:
            return max_batch
        budget_ms = max(0.0, self.slo_ms - self.dispatch_ms)
        if depth and oldest_wait_ms >= budget_ms:
            return depth
        return 0

    def describe(self) -> str:
        return (f"DeadlineBatch(slo_ms={self.slo_ms:g}, "
                f"dispatch_ms={self.dispatch_ms:g})")


@register_policy("cost")
class CostModelBatch(BatchPolicy):
    """Deadline batching with a calibrated, size-aware service estimate.

    :meth:`calibrate` fits a per-lane cost from a measurement window
    (``stats.serve_s / stats.batches`` at the engine's ``max_batch``,
    divided over ``data_shards`` devices and their lanes), which
    :meth:`estimate_ms` scales to any dispatch size.  Uncalibrated, it
    is :class:`DeadlineBatch` with ``dispatch_ms`` as a flat reservation.
    """

    def __init__(self, slo_ms: float = 50.0, dispatch_ms: float = 0.0):
        super().__init__(slo_ms, dispatch_ms)
        self._ms_per_lane: float | None = None
        self._data_shards: int = 1
        if self.slo_ms > 0 and self.dispatch_ms >= self.slo_ms:
            _warn("RPA103",
                  f"CostModelBatch: uncalibrated dispatch_ms="
                  f"{self.dispatch_ms:g} consumes the whole slo_ms="
                  f"{self.slo_ms:g} budget — until calibrate() runs, the "
                  f"policy collapses into dispatch-on-arrival")

    def calibrate(self, stats, max_batch: int,
                  data_shards: int = 1) -> "CostModelBatch":
        """Fit the per-lane cost from ``stats`` (whose ``serve_s`` /
        ``batches`` cover dispatches of ``max_batch``); a window with no
        dispatch changes nothing.  Returns self."""
        if getattr(stats, "batches", 0) > 0:
            per_dispatch_ms = stats.serve_s / stats.batches * 1e3
            shards = max(1, int(data_shards))
            lanes = max(1, max_batch // shards)
            self._ms_per_lane = per_dispatch_ms / shards / lanes
            self._data_shards = shards
        return self

    @property
    def calibrated(self) -> bool:
        return self._ms_per_lane is not None

    def estimate_ms(self, n: int) -> float:
        """Estimated service time of an ``n``-request dispatch."""
        if self._ms_per_lane is None:
            return self.dispatch_ms
        lanes = -(-max(1, n) // self._data_shards)       # ceil
        return self._ms_per_lane * lanes * self._data_shards

    def decide(self, depth: int, oldest_wait_ms: float,
               max_batch: int) -> int:
        if depth >= max_batch:
            return max_batch
        budget_ms = max(0.0, self.slo_ms - self.estimate_ms(depth))
        if depth and oldest_wait_ms >= budget_ms:
            return depth
        return 0

    def describe(self) -> str:
        est = (f"ms_per_lane={self._ms_per_lane:.3f} "
               f"x{self._data_shards} shards" if self.calibrated
               else f"uncalibrated, flat dispatch_ms={self.dispatch_ms:g}")
        return f"CostModelBatch(slo_ms={self.slo_ms:g}, {est})"


def make_policy(name_or_policy, slo_ms: float = 0.0,
                dispatch_ms: float = 0.0) -> BatchPolicy:
    """An instance passes through; a registry key makes
    ``POLICIES[name](slo_ms=..., dispatch_ms=...)``.  A plugin whose
    constructor takes no ``dispatch_ms`` is made without it, with a
    warning (RPA102) when a reservation would be dropped.  An unknown key
    raises ``KeyError`` listing the registered names."""
    if isinstance(name_or_policy, BatchPolicy):
        return name_or_policy
    cls = POLICIES.get(name_or_policy)
    try:
        accepts = any(p.name == "dispatch_ms"
                      or p.kind is inspect.Parameter.VAR_KEYWORD
                      for p in inspect.signature(cls).parameters.values())
    except (TypeError, ValueError):      # builtins / exotic callables
        accepts = True
    if accepts:
        return cls(slo_ms=slo_ms, dispatch_ms=dispatch_ms)
    if dispatch_ms:
        _warn("RPA102",
              f"policy {name_or_policy!r} does not accept dispatch_ms; the "
              f"spec's dispatch_ms={dispatch_ms:g} reservation is ignored")
    return cls(slo_ms=slo_ms)
