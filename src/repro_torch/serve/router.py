"""Replica routing for the pipeline fleet.

The twin of ``repro.serve.router``.  A router picks which replica of a
tenant's tier serves its next request, from read-only
:class:`ReplicaView` snapshots.  Routers live in the :data:`ROUTERS`
registry; ``FleetSpec.router`` names one::

    from repro_torch.serve.router import register_router

    @register_router("my-router")
    def my_router(tenant, candidates, state): ...

A router is a pure function of its arguments (the fleet owns ``state``,
one dict per tenant), so a virtual clock drives the fleet exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, MutableMapping, Sequence

from repro_torch.api.registry import Registry

ROUTERS = Registry("router")
register_router = ROUTERS.register

Router = Callable[[str, Sequence["ReplicaView"], MutableMapping], int]


@dataclasses.dataclass(frozen=True)
class ReplicaView:
    """What a router may know of one replica: ``pending`` counts its
    unresolved requests (queued and in flight: the load), ``depth`` its
    queued ones (the admission signal)."""
    replica_id: int
    tier: str
    depth: int
    pending: int
    max_batch: int


@register_router("least-loaded")
def least_loaded(tenant: str, candidates: Sequence[ReplicaView],
                 state: MutableMapping) -> int:
    """The candidate with the fewest unresolved requests; ties to the
    lowest replica id."""
    return min(candidates, key=lambda v: (v.pending, v.replica_id)).replica_id


@register_router("round-robin")
def round_robin(tenant: str, candidates: Sequence[ReplicaView],
                state: MutableMapping) -> int:
    """Cycle the tenant through its candidates in replica-id order (the
    counter is the tenant's own)."""
    ordered = sorted(v.replica_id for v in candidates)
    turn = state.get("rr", 0)
    state["rr"] = turn + 1
    return ordered[turn % len(ordered)]


@register_router("sticky")
def sticky(tenant: str, candidates: Sequence[ReplicaView],
           state: MutableMapping) -> int:
    """Always the lowest-id candidate."""
    return min(v.replica_id for v in candidates)


def route(router: Router, tenant: str, candidates: Sequence[ReplicaView],
          state: MutableMapping) -> int:
    """Run ``router`` and check that it picked one of the candidates."""
    if not candidates:
        raise ValueError(f"tenant {tenant!r} has no candidate replicas "
                         f"(empty tier) — FleetSpec validation should have "
                         f"rejected this")
    pick = router(tenant, candidates, state)
    if pick not in {v.replica_id for v in candidates}:
        raise ValueError(
            f"router returned replica {pick!r} for tenant {tenant!r} but "
            f"its candidates are {sorted(v.replica_id for v in candidates)}")
    return pick
