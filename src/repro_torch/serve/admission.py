"""Admission control: typed load shedding for the pipeline fleet.

The twin of ``repro.serve.admission``.  Before a request enters a
replica's queue, :class:`AdmissionController` checks the two bounds of
its :class:`~repro_torch.api.spec.TenantSpec`: ``max_inflight`` (the
tenant's unresolved requests: the bulkhead) and ``slo_ms`` (against what
the replica's calibrated cost model, ``POLICIES["cost"]``, says the queue
ahead costs to drain; an uncalibrated or fixed policy predicts nothing,
so only the bulkhead sheds).  A shed raises :class:`Overloaded` before
any future exists: nothing hangs, and admitted requests are delivered
exactly once.  The check reads no clock.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.api.spec import TenantSpec
from repro_torch.serve.router import ReplicaView

__all__ = ["Overloaded", "AdmissionController", "estimate_backlog_ms"]


class Overloaded(RuntimeError):
    """A request the fleet refused to queue, and why.

    ``reason`` is ``"max_inflight"`` or ``"slo"``; ``inflight`` / ``depth``
    are the tenant's unresolved count and the replica's queue depth at
    refusal; ``estimated_ms`` / ``slo_ms`` the backlog estimate that
    exceeded the SLO (``slo`` sheds only); ``limit`` the bulkhead.
    """

    def __init__(self, tenant: str, replica_id: int, reason: str, *,
                 inflight: int = 0, depth: int = 0,
                 estimated_ms: float = 0.0, slo_ms: float = 0.0,
                 limit: int = 0):
        self.tenant = tenant
        self.replica_id = replica_id
        self.reason = reason
        self.inflight = inflight
        self.depth = depth
        self.estimated_ms = estimated_ms
        self.slo_ms = slo_ms
        self.limit = limit
        if reason == "max_inflight":
            msg = (f"tenant {tenant!r} shed: {inflight} requests already "
                   f"in flight >= max_inflight={limit}")
        else:
            msg = (f"tenant {tenant!r} shed at replica {replica_id}: queue "
                   f"depth {depth} needs ~{estimated_ms:.1f} ms to drain, "
                   f"over the {slo_ms:g} ms SLO")
        super().__init__(msg)


def estimate_backlog_ms(policy, depth: int, max_batch: int
                        ) -> Optional[float]:
    """What the replica's policy predicts a queue of ``depth`` requests
    (the arriving one included) costs to serve, in ms: full dispatches
    first, then the tail, each priced by the calibrated cost model's
    ``estimate_ms``.  None when the policy has no calibrated model."""
    estimate = getattr(policy, "estimate_ms", None)
    if estimate is None or not getattr(policy, "calibrated", False):
        return None
    if depth <= 0:
        return 0.0
    full, tail = divmod(depth, max_batch)
    total = full * estimate(max_batch)
    if tail:
        total += estimate(tail)
    return total


class AdmissionController:
    """The stateless admission check (its state arrives as arguments)."""

    def check(self, tenant: TenantSpec, inflight: int,
              view: ReplicaView, policy) -> None:
        """Admit (return None) or shed (raise :class:`Overloaded`) one
        request of ``tenant`` routed to the replica ``view``, whose batch
        policy is ``policy``."""
        if inflight >= tenant.max_inflight:
            raise Overloaded(tenant.name, view.replica_id, "max_inflight",
                             inflight=inflight, limit=tenant.max_inflight)
        if tenant.slo_ms > 0:
            est = estimate_backlog_ms(policy, view.depth + 1,
                                      view.max_batch)
            if est is not None and est > tenant.slo_ms:
                raise Overloaded(tenant.name, view.replica_id, "slo",
                                 depth=view.depth, estimated_ms=est,
                                 slo_ms=tenant.slo_ms)
