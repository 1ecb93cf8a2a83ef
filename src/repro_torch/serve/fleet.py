"""Fleet serving: a multi-tenant, SLO-aware router over a pipeline pool.

The twin of ``repro.serve.fleet``.  :class:`PipelineFleet` serves the
paper's accuracy/throughput ladder behind one front door:

* **Pool**: one built pipeline per replica (``api.build.build_pool``;
  unsharded replicas of one spec and params share one pipeline), each
  with its own
  :class:`~repro_torch.serve.async_engine.AsyncPointCloudEngine` on a
  shared clock and seed.  Unsharded replicas share one device and its
  default stream, as the JAX package's share one device.  A sharded pool
  (``data_shards > 1``) places replica ``r`` on row ``r`` of a
  ``("replica", "data")`` mesh (``serve.sharding.make_mesh2d``), each
  replica's dispatch split over its row.
* **Routing**: ``submit(tenant, cloud)``; the tenant's
  :class:`~repro_torch.api.spec.TenantSpec` names its tier and the
  fleet's router (``serve.router.ROUTERS``) picks a replica of that tier.
* **Admission**: the :class:`~repro_torch.serve.admission.
  AdmissionController` sheds past the tenant's ``max_inflight`` or its
  ``slo_ms`` (once the replica's cost model is calibrated), raising a
  typed :class:`~repro_torch.serve.admission.Overloaded` before any
  future exists.

Every replica engine restarts each dispatch from the shared seed state,
so a tenant's logits are bit for bit those of its tier's pipeline alone,
whichever replica served it and whatever shared the dispatch.

Driving it::

    fleet = PipelineFleet.from_specs(fleet_spec, params_by_name)
    fut = fleet.submit("lidar", cloud)        # may raise Overloaded
    fleet.pump(); fleet.flush()
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
import time
from typing import Callable, Dict, List, Mapping, Sequence

import numpy as np

from repro_torch.api.build import FrozenPipeline, build_pool
from repro_torch.api.spec import FleetSpec, TenantSpec
from repro_torch.serve.admission import AdmissionController, Overloaded
from repro_torch.serve.async_engine import AsyncPointCloudEngine, ServeFuture
from repro_torch.serve.router import ROUTERS, ReplicaView, route
from repro_torch.serve.streaming import AsyncStreamSession, require_streaming

__all__ = ["PipelineFleet", "Replica", "TenantState", "Overloaded"]


@dataclasses.dataclass
class Replica:
    """One pool slot: a built pipeline and its own engine."""
    replica_id: int
    tier: str                      # the pipeline spec's name
    engine: AsyncPointCloudEngine

    def view(self) -> ReplicaView:
        """The queue snapshot routers and admission read."""
        return ReplicaView(replica_id=self.replica_id, tier=self.tier,
                           depth=self.engine.depth,
                           pending=self.engine.pending,
                           max_batch=self.engine.max_batch)


@dataclasses.dataclass
class TenantState:
    """Live accounting for one tenant (``spec`` is the declared part)."""
    spec: TenantSpec
    submitted: int = 0             # admitted requests
    shed: int = 0                  # Overloaded refusals
    inflight: int = 0              # admitted, not yet resolved
    router_state: dict = dataclasses.field(default_factory=dict)
    latencies_ms: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=10_000))

    @property
    def shed_rate(self) -> float:
        """Shed share of everything offered (admitted and shed)."""
        offered = self.submitted + self.shed
        return self.shed / offered if offered else 0.0


class PipelineFleet:
    """Multi-tenant serving over a pool of frozen pipelines.

    Args:
      pool: one :class:`FrozenPipeline` per replica, in
        ``fleet_spec.pool_specs()`` order (:meth:`from_specs` builds it).
      fleet_spec: the deployment (tenants, tiers, router, ``max_batch``).
      seed: LFSR seed of every replica engine.
      clock: monotonic seconds shared by every engine and the tenants'
        timing (inject a virtual clock to drive it deterministically).
      calibrate_every: each replica engine's periodic cost-model refit.
    """

    def __init__(self, pool: Sequence[FrozenPipeline],
                 fleet_spec: FleetSpec, *, seed: int = 0,
                 clock: Callable[[], float] = time.monotonic,
                 calibrate_every: int = 64):
        specs = fleet_spec.pool_specs()
        if len(pool) != len(specs):
            raise ValueError(
                f"pool has {len(pool)} pipelines but the fleet spec "
                f"describes {len(specs)} replicas ({fleet_spec.replicas} x "
                f"{len(fleet_spec.pipelines)} pipelines)")
        for pipe, spec in zip(pool, specs):
            if pipe.spec.name != spec.name:
                raise ValueError(
                    f"pool order must match FleetSpec.pool_specs(): got "
                    f"pipeline {pipe.spec.name!r} in the {spec.name!r} slot")
        self.spec = fleet_spec
        self._router = ROUTERS.get(fleet_spec.router)
        self._admission = AdmissionController()
        self._clock = clock
        self.replicas: List[Replica] = [
            Replica(replica_id=i, tier=pipe.spec.name,
                    engine=AsyncPointCloudEngine(
                        pipe, max_batch=fleet_spec.max_batch, seed=seed,
                        clock=clock, calibrate_every=calibrate_every))
            for i, pipe in enumerate(pool)]
        self.tenants: Dict[str, TenantState] = {
            t.name: TenantState(spec=t) for t in fleet_spec.tenants}
        self._tier_replicas: Dict[str, List[Replica]] = {}
        for rep in self.replicas:
            self._tier_replicas.setdefault(rep.tier, []).append(rep)
        self._closed = False

    @classmethod
    def from_specs(cls, fleet_spec: FleetSpec,
                   params_by_name: Mapping[str, dict], *, device=None,
                   mesh=None, **kwargs) -> "PipelineFleet":
        """Validate the spec, build its pool on ``device`` (default
        ``cuda``; raises without a GPU) and the fleet over it.  A sharded
        pool is placed on ``mesh``, a ``("replica", "data")`` mesh with
        one row per replica (None: ``make_mesh2d`` over the first CUDA
        devices)."""
        fleet_spec.validate()
        pool = build_pool(fleet_spec.pool_specs(), params_by_name,
                          device=device, mesh=mesh)
        return cls(pool, fleet_spec, **kwargs)

    # ------------------------------------------------------ sans-IO ----

    def _tenant(self, tenant: str) -> TenantState:
        try:
            return self.tenants[tenant]
        except KeyError:
            raise KeyError(
                f"unknown tenant {tenant!r}; registered tenants: "
                f"{', '.join(sorted(self.tenants))}") from None

    def _route_admit(self, tenant: str):
        """Route and admit, before any future exists: returns
        ``(tenant_state, replica)`` or raises ``Overloaded`` / ``KeyError``."""
        if self._closed:
            raise RuntimeError("fleet is closed")
        state = self._tenant(tenant)
        candidates = self._tier_replicas[state.spec.tier]
        pick = route(self._router, tenant, [r.view() for r in candidates],
                     state.router_state)
        replica = self.replicas[pick]
        try:
            self._admission.check(state.spec, state.inflight,
                                  replica.view(), replica.engine.policy)
        except Overloaded:
            state.shed += 1
            raise
        return state, replica

    def _settle_admitted(self, state: TenantState,
                         fut: ServeFuture) -> ServeFuture:
        state.submitted += 1
        state.inflight += 1

        def settle(f: ServeFuture, _state=state) -> None:
            _state.inflight -= 1
            _state.latencies_ms.append(f.latency_ms)

        fut.add_done_callback(settle)
        return fut

    def submit(self, tenant: str, points) -> ServeFuture:
        """Route and admit one [N, 3] cloud of ``tenant``: its future, or
        :class:`Overloaded` on a shed (counted, no future made), or
        ``KeyError`` for an unknown tenant."""
        state, replica = self._route_admit(tenant)
        return self._settle_admitted(state, replica.engine.submit(points))

    def open_stream(self, tenant: str, *, max_age=None):
        """An :class:`~repro_torch.serve.streaming.AsyncStreamSession` of
        ``tenant`` over the routed submit path.  Each frame is routed and
        admitted as :meth:`submit` does (a shed leaves the session's cache
        as it was).  The cache holds across the tier's replicas: they
        share spec, params and seed.  Needs a ``stream=True`` tier."""
        tstate = self._tenant(tenant)
        pipe = self._tier_replicas[tstate.spec.tier][0].engine.pipeline
        require_streaming(pipe)

        def submit_stream(cloud, cstate, hit):
            state, replica = self._route_admit(tenant)
            fut = replica.engine._submit_stream(cloud, cstate, hit)
            return self._settle_admitted(state, fut)

        return AsyncStreamSession(
            submit_stream, n_points=pipe.model_config.n_points,
            threshold=pipe.spec.stream_drift_threshold, max_age=max_age)

    def pump(self, block: bool = True) -> int:
        """One scheduler turn over the pool, in replica order; returns the
        requests dispatched."""
        return sum(rep.engine.pump(block=block) for rep in self.replicas)

    def flush(self) -> None:
        """Drain every replica; every admitted future resolves."""
        for rep in self.replicas:
            rep.engine.flush()

    @property
    def depth(self) -> int:
        """Queued (not yet dispatched) requests over the pool."""
        return sum(rep.engine.depth for rep in self.replicas)

    @property
    def pending(self) -> int:
        """Unresolved requests over the pool: queued and in flight."""
        return sum(rep.engine.pending for rep in self.replicas)

    def warmup(self) -> float:
        """Run each distinct pipeline's dispatch shape once (replicas that
        share a pipeline run it once); returns the seconds."""
        seen, total = set(), 0.0
        for rep in self.replicas:
            if id(rep.engine.pipeline) not in seen:
                seen.add(id(rep.engine.pipeline))
                total += rep.engine.warmup()
        return total

    def calibrate(self) -> int:
        """Refit every replica's cost model now; returns how many took
        it."""
        return sum(bool(rep.engine.calibrate_policy())
                   for rep in self.replicas)

    # -------------------------------------------------------- stats ----

    def stats(self) -> dict:
        """Pool counters, summed over the replica engines."""
        agg = {"requests": 0, "batches": 0, "padded": 0, "serve_s": 0.0,
               "host_s": 0.0, "compile_s": 0.0}
        for rep in self.replicas:
            for key in agg:
                agg[key] += getattr(rep.engine.stats, key)
        agg["samples_per_s"] = (agg["requests"] / agg["serve_s"]
                                if agg["serve_s"] > 0 else 0.0)
        agg["shed"] = sum(t.shed for t in self.tenants.values())
        return agg

    def tenant_stats(self) -> Dict[str, dict]:
        """Per tenant: volumes, shed rate and latency percentiles (ms, on
        the fleet clock)."""
        out = {}
        for name, state in self.tenants.items():
            lat = np.asarray(state.latencies_ms, dtype=np.float64)
            out[name] = {
                "tier": state.spec.tier, "slo_ms": state.spec.slo_ms,
                "submitted": state.submitted, "shed": state.shed,
                "shed_rate": state.shed_rate, "inflight": state.inflight,
                "p50_ms": float(np.percentile(lat, 50)) if lat.size else None,
                "p99_ms": float(np.percentile(lat, 99)) if lat.size else None,
            }
        return out

    def reset_stats(self) -> None:
        """A fresh measurement window over the pool and every tenant."""
        for rep in self.replicas:
            rep.engine.reset_stats()
        for state in self.tenants.values():
            state.submitted = 0
            state.shed = 0
            state.latencies_ms.clear()

    def describe(self) -> str:
        lines = [f"PipelineFleet({self.spec.name}): {len(self.replicas)} "
                 f"replicas ({self.spec.replicas} x "
                 f"{len(self.spec.pipelines)} pipelines), "
                 f"router={self.spec.router}, "
                 f"max_batch={self.spec.max_batch}, "
                 f"data_shards={self.spec.data_shards}"]
        for rep in self.replicas:
            mesh = rep.engine.pipeline.mesh
            where = (f"devices {[str(d) for d in mesh.devices.flat]}"
                     if mesh is not None else f"device {rep.engine.device}")
            lines.append(f"  replica {rep.replica_id}: tier={rep.tier} "
                         f"({where}); "
                         f"policy={rep.engine.policy.describe()}")
        for t in self.spec.tenants:
            lines.append(f"  tenant {t.name}: tier={t.tier} "
                         f"slo_ms={t.slo_ms:g} max_inflight={t.max_inflight}")
        return "\n".join(lines)

    # ------------------------------------------------ asyncio shell ----

    async def classify_async(self, tenant: str, points):
        """Submit one cloud of ``tenant`` and await its logits (run
        :meth:`serve_loop` beside it).  ``Overloaded`` reaches the caller
        at once: a shed is an answer, not a wait."""
        loop = asyncio.get_running_loop()
        afut = loop.create_future()

        def on_done(fut: ServeFuture) -> None:
            def settle() -> None:
                if not afut.done():
                    afut.set_result(fut.result())
            loop.call_soon_threadsafe(settle)

        self.submit(tenant, points).add_done_callback(on_done)
        return await afut

    async def serve_loop(self, tick_s: float = 0.001) -> None:
        """Pump the pool every ``tick_s`` (non-blocking) until
        :meth:`close`, then flush."""
        while not self._closed:
            self.pump(block=False)
            await asyncio.sleep(tick_s)
        self.flush()

    def close(self) -> None:
        """Stop accepting requests; a running serve_loop flushes and
        exits."""
        self._closed = True
        for rep in self.replicas:
            rep.engine.close()
