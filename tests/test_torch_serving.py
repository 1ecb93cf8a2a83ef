"""Parity of the port's async engine, policies, router, admission and fleet with ``repro.serve``.

Both packages serve the same clouds (``np.random.default_rng``) with the
same parameters (``repro.models.pointmlp.pointmlp_init``, BN perturbed)
at the tiny serving spec of ``tests/serving/harness.py`` (128 points,
embed 16, k = 8, fp32; JAX on its ``ref`` backend, the port on the CPU),
driven by the harness's virtual clock, so every scheduling quantity is
exact:

* policy decisions, dispatch counts and sizes, pad lanes, every future's
  latency, replica choices and sheds are identical;
* within the port a future is bitwise equal to its cloud served alone
  (zero-padded to ``max_batch``, from the seed LFSR state);
* against JAX, logits agree within 1e-4 of max|logit| (rtol 1e-4), on
  the clouds whose kNN lists match (a near-tie swap is reported and the
  cloud left out, as in ``test_torch_pipeline``).
"""
import asyncio
import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "serving"))
from harness import (TINY, Arrival, VirtualClock,  # noqa: E402
                     bursty_trace, fleet_bursty_trace, fleet_overload_trace,
                     fleet_steady_trace, run_trace, steady_trace,
                     trickle_trace)

from repro.api import FleetSpec as JaxFleetSpec  # noqa: E402
from repro.api import TenantSpec as JaxTenantSpec  # noqa: E402
from repro.api import build_pool as jax_build_pool  # noqa: E402
from repro.api.build import build as jax_build  # noqa: E402
from repro.serve import admission as jadmission  # noqa: E402
from repro.serve import policy as jpolicy  # noqa: E402
from repro.serve import router as jrouter  # noqa: E402
from repro.serve.async_engine import \
    AsyncPointCloudEngine as JaxAsync  # noqa: E402
from repro.serve.fleet import PipelineFleet as JaxFleet  # noqa: E402
from repro_torch.api.build import build, build_pool  # noqa: E402
from repro_torch.api.spec import (FleetSpec, TenantSpec,  # noqa: E402
                                  UnknownKeyError)
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.serve import admission, policy, router  # noqa: E402
from repro_torch.serve.async_engine import (AsyncPointCloudEngine,  # noqa
                                            ServeFuture)
from repro_torch.serve.batching import (check_shard_batch,  # noqa: E402
                                        pad_to_batch, stack_requests)
from repro_torch.serve.fleet import PipelineFleet  # noqa: E402
from repro_torch.serve.sharding import make_mesh2d  # noqa: E402
from test_torch_streaming import (SEED, bitwise, jax_spec,  # noqa: E402
                                  jax_tree, mapping_matches,
                                  perturbed_params, port_spec)

MAX_BATCH = 4
RTOL = 1e-4
N_CLOUDS = 12


def serving_port(**over):
    return port_spec(stream=False, stream_drift_threshold=0.0, **over)


def serving_jax(**over):
    return jax_spec(stream=False, stream_drift_threshold=0.0, **over)


@pytest.fixture(scope="module")
def params_np():
    return perturbed_params()


@pytest.fixture(scope="module")
def clouds():
    return list(np.random.default_rng(2).standard_normal(
        (N_CLOUDS, TINY["n_points"], 3)).astype(np.float32))


@pytest.fixture(scope="module")
def clean(clouds):
    return [mapping_matches(c) for c in clouds]


@pytest.fixture(scope="module")
def pipes(params_np):
    """(port pipeline, JAX pipeline) of the tiny serving spec."""
    assert (dataclasses.asdict(serving_port())
            == dataclasses.asdict(serving_jax()))
    return (build(serving_port(), from_numpy_tree(params_np), device="cpu"),
            jax_build(serving_jax(), jax_tree(params_np)))


@pytest.fixture(scope="module")
def solo(pipes):
    """``solo(cloud, max_batch)``: the port's logits of ``cloud`` alone,
    zero-padded to ``max_batch``, from the seed state."""
    port = pipes[0]
    memo = {}

    def ref(cloud, max_batch=MAX_BATCH):
        key = (cloud.tobytes(), max_batch)
        if key not in memo:
            batch, _ = pad_to_batch(torch.from_numpy(cloud[None]), max_batch)
            logits, _ = port.infer(batch, port.seed_state(SEED, max_batch))
            memo[key] = logits[0]
        return memo[key]
    return ref


def assert_close(got, want, ok):
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        if ok[i]:
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=RTOL, atol=RTOL * scale,
                                       err_msg=f"request {i}")


# ----------------------------------------------------------- policies --

class TestPolicies:
    def test_registry_matches_jax(self):
        assert policy.POLICIES.names() == jpolicy.POLICIES.names()
        with pytest.raises(KeyError, match="deadline"):
            policy.POLICIES.get("deadlin")

    @pytest.mark.parametrize("name", ["fixed", "deadline", "cost"])
    @pytest.mark.parametrize("slo,dispatch", [(0.0, 0.0), (10.0, 0.0),
                                              (10.0, 4.0), (50.0, 12.5)])
    def test_decisions_match_jax(self, name, slo, dispatch):
        mine = policy.make_policy(name, slo_ms=slo, dispatch_ms=dispatch)
        theirs = jpolicy.make_policy(name, slo_ms=slo, dispatch_ms=dispatch)
        assert mine.describe() == theirs.describe()
        for depth in range(10):
            for wait in (0.0, 3.9, 4.0, 5.9, 6.0, 9.9, 10.0, 37.5, 1e9):
                for mb in (1, 4, 8):
                    assert mine.decide(depth, wait, mb) == theirs.decide(
                        depth, wait, mb), (depth, wait, mb)

    @pytest.mark.parametrize("shards", [1, 2])
    def test_cost_model_calibration_matches_jax(self, shards):
        class Window:
            batches, serve_s = 3, 0.0123
        mine = policy.CostModelBatch(slo_ms=8.0).calibrate(
            Window, 8, data_shards=shards)
        theirs = jpolicy.CostModelBatch(slo_ms=8.0).calibrate(
            Window, 8, data_shards=shards)
        assert mine.calibrated and theirs.calibrated
        assert mine.describe() == theirs.describe()
        for n in range(10):
            assert mine.estimate_ms(n) == theirs.estimate_ms(n)
            for wait in (0.0, 1.0, 4.0, 7.9):
                assert mine.decide(n, wait, 8) == theirs.decide(n, wait, 8)
        empty = policy.CostModelBatch().calibrate(type("W", (), {
            "batches": 0, "serve_s": 0.0}), 8)
        assert not empty.calibrated and empty.estimate_ms(3) == 0.0

    def test_collapse_and_dropped_reservation_warn_as_jax(self):
        for mod in (policy, jpolicy):
            with pytest.warns(UserWarning, match="RPA103.*dispatch-on-"):
                pol = mod.DeadlineBatch(slo_ms=10.0, dispatch_ms=10.0)
            assert pol.decide(depth=1, oldest_wait_ms=0.0, max_batch=4) == 1
            with pytest.warns(UserWarning, match="RPA103"):
                mod.CostModelBatch(slo_ms=5.0, dispatch_ms=6.0)

            class Legacy(mod.BatchPolicy):
                def __init__(self, slo_ms: float = 0.0):
                    super().__init__(slo_ms)

                def decide(self, depth, oldest_wait_ms, max_batch):
                    return depth

            mod.register_policy("_test_legacy_ctor")(Legacy)
            try:
                with pytest.warns(UserWarning, match="RPA102.*dispatch_ms"):
                    pol = mod.make_policy("_test_legacy_ctor", slo_ms=1.0,
                                          dispatch_ms=2.0)
                assert pol.slo_ms == 1.0
            finally:
                mod.POLICIES.unregister("_test_legacy_ctor")

    def test_unknown_policy_is_rpa005(self, params_np):
        spec = serving_port().serving(policy="nope")
        with pytest.raises(KeyError, match="RPA005.*deadline"):
            spec.validate()
        with pytest.raises(ValueError, match="RPA005.*policy"):
            AsyncPointCloudEngine.from_params(from_numpy_tree(params_np),
                                              spec, device="cpu")
        with pytest.raises(KeyError, match="RPA005"):
            serving_jax().serving(policy="nope").validate()


# ------------------------------------------------------- async engine --

TRACES = {
    "bursty": lambda c: bursty_trace(c, burst=MAX_BATCH),
    "trickle": lambda c: trickle_trace(c[:5], gap_ms=40.0),
    "steady": lambda c: steady_trace(c, gap_ms=3.0),
}


def run_both(pipes, trace, policy_name, slo_ms=10.0, **run_kw):
    """The same trace through both engines; returns (port, jax) each as
    (engine, futures)."""
    out = []
    for pipe, cls in ((pipes[0], AsyncPointCloudEngine),
                      (pipes[1], JaxAsync)):
        clock = VirtualClock()
        pol = (policy.DeadlineBatch if cls is AsyncPointCloudEngine
               else jpolicy.DeadlineBatch)(slo_ms=slo_ms) \
            if policy_name == "deadline" else policy_name
        eng = cls(pipe, max_batch=MAX_BATCH, policy=pol, seed=SEED,
                  clock=clock)
        out.append((eng, run_trace(eng, trace, clock, **run_kw)))
    return out


def stats_of(eng):
    s = eng.stats
    return s.requests, s.batches, s.padded


class TestAsyncEngine:
    @pytest.mark.parametrize("policy_name", ["fixed", "deadline"])
    @pytest.mark.parametrize("trace", sorted(TRACES))
    def test_trace_matches_jax_and_solo(self, pipes, clouds, clean, solo,
                                        trace, policy_name):
        """The same dispatches and latencies as JAX's engine; every
        future bitwise its cloud served alone."""
        arrivals = TRACES[trace](clouds)
        (eng, futs), (jeng, jfuts) = run_both(pipes, arrivals, policy_name)
        assert stats_of(eng) == stats_of(jeng)
        assert [f.latency_ms for f in futs] == [f.latency_ms for f in jfuts]
        assert all(f.done() for f in futs)
        for a, f in zip(arrivals, futs):
            assert bitwise(f.result(), solo(a.cloud))
        idx = [next(i for i, c in enumerate(clouds) if c is a.cloud)
               for a in arrivals]
        assert_close([f.result() for f in futs],
                     [f.result() for f in jfuts], [clean[i] for i in idx])

    def test_fixed_policy_holds_a_partial_tail(self, pipes, clouds):
        (eng, futs), (jeng, _) = run_both(
            pipes, trickle_trace(clouds[:3], gap_ms=30.0), "fixed",
            flush=False)
        assert stats_of(eng) == stats_of(jeng) == (0, 0, 0)
        assert not any(f.done() for f in futs)
        eng.flush()
        assert stats_of(eng) == (3, 1, 1) and all(f.done() for f in futs)

    def test_results_independent_of_dispatch_width(self, pipes, clouds):
        """A lane's logits do not depend on max_batch (the head's lone
        row at width 1 included)."""
        port = pipes[0]
        for width in (1, 2, 8):
            eng = AsyncPointCloudEngine(port, max_batch=width,
                                        policy="fixed", seed=SEED,
                                        clock=VirtualClock())
            futs = [eng.submit(c) for c in clouds[:3]]
            eng.flush()
            for c, f in zip(clouds, futs):
                batch, _ = pad_to_batch(torch.from_numpy(c[None]), MAX_BATCH)
                want, _ = port.infer(batch, port.seed_state(SEED, MAX_BATCH))
                assert bitwise(f.result(), want[0]), width

    def test_double_buffer_and_nonblocking_pump(self, pipes, clouds):
        eng = AsyncPointCloudEngine(pipes[0], max_batch=2, policy="fixed",
                                    seed=SEED, clock=VirtualClock())
        futs = [eng.submit(c) for c in clouds[:4]]
        assert eng.pump() == 2 and eng.pending == 4 and eng.depth == 2
        assert eng.pump() == 2                  # retires the first batch
        assert [f.done() for f in futs] == [True, True, False, False]
        assert eng.pump(block=False) == 0       # CPU work is ready at once
        assert all(f.done() for f in futs) and eng.pending == 0

    def test_futures(self, pipes, clouds):
        clock = VirtualClock(5.0)
        eng = AsyncPointCloudEngine(pipes[0], max_batch=MAX_BATCH,
                                    policy="fixed", seed=SEED, clock=clock)
        fut = eng.submit(clouds[0])
        assert isinstance(fut, ServeFuture) and fut.latency_ms is None
        with pytest.raises(RuntimeError, match="still pending"):
            fut.result()
        seen = []
        fut.add_done_callback(lambda f: seen.append(f.request_id))
        fut.add_done_callback(lambda f: 1 / 0)
        second = eng.submit(clouds[1])
        clock.advance(0.0125)
        with pytest.warns(RuntimeWarning, match="ZeroDivisionError"):
            eng.flush()
        assert seen == [0] and second.done()
        assert fut.latency_ms == pytest.approx(12.5)
        fut.add_done_callback(lambda f: seen.append("late"))
        assert seen == [0, "late"]
        with pytest.raises(AssertionError, match="exactly once"):
            fut._resolve(fut.result(), 0.0)
        with pytest.raises(ValueError, match=r"one \[N=128, 3\]"):
            eng.submit(np.zeros((64, 3), np.float32))
        eng.close()
        with pytest.raises(RuntimeError, match="closed"):
            eng.submit(clouds[0])

    def test_needs_a_serving_spec_and_a_frozen_pipeline(self, params_np):
        raw = build(serving_port().replace(shared_urs=False,
                                           per_sample_norm=False),
                    from_numpy_tree(params_np), device="cpu")
        with pytest.raises(ValueError, match="serving spec"):
            AsyncPointCloudEngine(raw)
        with pytest.raises(TypeError, match="FrozenPipeline"):
            AsyncPointCloudEngine(object())
        with pytest.raises(ValueError, match="calibrate_every"):
            AsyncPointCloudEngine(build(serving_port(),
                                        from_numpy_tree(params_np),
                                        device="cpu"), calibrate_every=-1)

    def test_policy_from_spec_fields(self, params_np):
        spec = serving_port().serving(policy="deadline", slo_ms=20.0,
                                      dispatch_ms=5.0)
        eng = AsyncPointCloudEngine.from_params(
            from_numpy_tree(params_np), spec, device="cpu", max_batch=2,
            clock=VirtualClock())
        assert isinstance(eng.policy, policy.DeadlineBatch)
        assert (eng.policy.slo_ms, eng.policy.dispatch_ms) == (20.0, 5.0)
        assert "DeadlineBatch(slo_ms=20" in eng.describe()

    def test_warmup_keeps_the_queue(self, pipes, clouds):
        eng = AsyncPointCloudEngine(pipes[0], max_batch=2, seed=SEED,
                                    clock=VirtualClock())
        eng.submit(clouds[0])
        assert eng.warmup() > 0
        assert eng.depth == 1 and eng.stats.compile_s > 0
        assert eng.stats.batches == 0

    def test_cost_policy_calibrates_from_its_windows(self, pipes, clouds):
        eng = AsyncPointCloudEngine(pipes[0], max_batch=2, policy="cost",
                                    seed=SEED, clock=VirtualClock(),
                                    calibrate_every=2)
        assert not eng.calibrate_policy()       # no dispatch yet
        for c in clouds[:4]:
            eng.submit(c)
        eng.flush()
        assert not eng.policy.calibrated
        eng.pump()                              # two dispatches: a window
        assert eng.policy.calibrated
        assert eng.calibrate_policy()
        fixed = AsyncPointCloudEngine(pipes[0], max_batch=2, policy="fixed")
        assert not fixed.calibrate_policy()
        eng.reset_stats()
        assert eng.stats.batches == 0 and not eng.latencies_ms

    def test_asyncio_shell(self, pipes, clouds, solo):
        async def scenario():
            eng = AsyncPointCloudEngine(pipes[0], max_batch=MAX_BATCH,
                                        policy="deadline", seed=SEED)
            server = asyncio.create_task(eng.serve_loop(tick_s=1e-4))
            outs = await asyncio.wait_for(asyncio.gather(
                *[eng.classify_async(c) for c in clouds[:5]]), 60)
            tail = [eng.submit(c) for c in clouds[5:7]]
            eng.close()
            await server
            return eng, outs, tail

        eng, outs, tail = asyncio.run(scenario())
        assert eng.stats.requests == 7 and all(f.done() for f in tail)
        for c, out in zip(clouds, outs):
            assert bitwise(out, solo(c))

    def test_batching_helpers(self):
        stacked = stack_requests([np.zeros((4, 3))] * 2, 4)
        assert stacked.dtype == torch.float32 and stacked.shape == (2, 4, 3)
        with pytest.raises(ValueError, match="request 1: shape"):
            stack_requests([np.zeros((4, 3)), np.zeros((5, 3))], 4)
        check_shard_batch(8, 1)
        with pytest.raises(ValueError, match="must divide"):
            check_shard_batch(3, 2)


# ------------------------------------------------- router, admission --

def views(mod, pendings, depths=None):
    depths = depths or [0] * len(pendings)
    return [mod.ReplicaView(replica_id=i, tier="t", depth=d, pending=p,
                            max_batch=4)
            for i, (p, d) in enumerate(zip(pendings, depths))]


class _StubCost:
    """A calibrated cost model at ``ms`` per request."""

    def __init__(self, ms=10.0):
        self.ms, self.calibrated = ms, True

    def estimate_ms(self, n):
        return self.ms * n


class TestRouterAndAdmission:
    @pytest.mark.parametrize("name", ["least-loaded", "round-robin",
                                      "sticky"])
    def test_picks_match_jax(self, name):
        assert router.ROUTERS.names() == jrouter.ROUTERS.names()
        rng = np.random.default_rng(4)
        mine, theirs = router.ROUTERS.get(name), jrouter.ROUTERS.get(name)
        m_state, t_state = {}, {}
        for _ in range(40):
            pend = list(rng.integers(0, 5, rng.integers(1, 5)))
            assert router.route(mine, "t", views(router, pend), m_state) == \
                jrouter.route(theirs, "t", views(jrouter, pend), t_state)
        assert m_state == t_state

    def test_route_validates_the_pick(self):
        with pytest.raises(ValueError, match="candidates"):
            router.route(lambda t, c, s: 99, "t", views(router, [0]), {})
        with pytest.raises(ValueError, match="no candidate"):
            router.route(router.sticky, "t", [], {})

    def test_backlog_estimate_matches_jax(self):
        class Fixed:
            pass
        for depth in range(0, 11):
            assert admission.estimate_backlog_ms(_StubCost(), depth, 4) == \
                jadmission.estimate_backlog_ms(_StubCost(), depth, 4)
        assert admission.estimate_backlog_ms(Fixed(), 5, 4) is None
        uncal = _StubCost()
        uncal.calibrated = False
        assert admission.estimate_backlog_ms(uncal, 5, 4) is None

    @pytest.mark.parametrize("inflight,depth,ms,slo", [
        (2, 0, 10.0, 15.0), (0, 1, 10.0, 15.0), (1, 0, 5.0, 15.0),
        (0, 100, 10.0, 0.0), (0, 1, 7.5, 15.0)])
    def test_check_matches_jax(self, inflight, depth, ms, slo):
        outcome = []
        for mod, spec_mod in ((admission, TenantSpec),
                              (jadmission, JaxTenantSpec)):
            tenant = spec_mod("t", "tier", slo_ms=slo, max_inflight=2)
            view = views(router, [0], [depth])[0]
            try:
                mod.AdmissionController().check(tenant, inflight, view,
                                                _StubCost(ms))
                outcome.append(None)
            except mod.Overloaded as exc:
                outcome.append((exc.reason, exc.estimated_ms, str(exc)))
        assert outcome[0] == outcome[1]


# ---------------------------------------------------------------- fleet --

def fleet_specs():
    """The fleet of ``tests/serving/conftest.py`` in both packages: the
    tiny model under two tier names, two replicas each, two tenants
    without SLO shedding."""
    out = []
    for fs, ts, spec_fn in ((FleetSpec, TenantSpec, serving_port),
                            (JaxFleetSpec, JaxTenantSpec, serving_jax)):
        a, b = spec_fn(), spec_fn(name="tiny-b")
        out.append(fs(pipelines=(a, b),
                      tenants=(ts("rt", a.name, slo_ms=0.0),
                               ts("bulk", "tiny-b", slo_ms=0.0)),
                      replicas=2, max_batch=MAX_BATCH))
    return out


@pytest.fixture(scope="module")
def pools(params_np):
    port_fs, jax_fs = fleet_specs()
    return (build_pool(port_fs.pool_specs(),
                       {p.name: from_numpy_tree(params_np)
                        for p in port_fs.pipelines}, device="cpu"),
            jax_build_pool(jax_fs.pool_specs(),
                           {p.name: jax_tree(params_np)
                            for p in jax_fs.pipelines}))


def drive_fleet(fleet, trace, clock, overloaded):
    """``harness.run_fleet_trace`` for either package, with blocking
    pumps: an idle pump retires the dispatch in flight at once, so every
    retire time is the same on both sides (JAX's non-blocking pump
    retires when XLA's asynchronous dispatch happens to be done).
    Returns (admitted [(arrival, future)], shed [(arrival, exc)], the
    pool's pending counts after each submission)."""
    admitted, shed, placements = [], [], []
    for arrival in sorted(trace, key=lambda a: a.t_ms):
        while clock() < arrival.t_ms / 1e3:
            clock.advance(min(1e-3, arrival.t_ms / 1e3 - clock()))
            fleet.pump()
        try:
            admitted.append((arrival,
                             fleet.submit(arrival.tenant, arrival.cloud)))
        except overloaded as exc:
            shed.append((arrival, exc))
        placements.append([r.engine.pending for r in fleet.replicas])
        fleet.pump()
    deadline_s = clock() + 0.5
    while fleet.pending and clock() < deadline_s:
        clock.advance(1e-3)
        fleet.pump()
    fleet.flush()
    return admitted, shed, placements


def run_fleets(pools, trace, fleet_over=None, tweak=None):
    runs = []
    for pool, fspec, fleet_cls, overloaded in (
            (pools[0], fleet_specs()[0], PipelineFleet, admission.Overloaded),
            (pools[1], fleet_specs()[1], JaxFleet, jadmission.Overloaded)):
        if fleet_over:
            fspec = fleet_over(fspec)
        clock = VirtualClock()
        fleet = fleet_cls(pool, fspec, seed=SEED, clock=clock)
        if tweak:
            tweak(fleet)
        runs.append((fleet, *drive_fleet(fleet, trace, clock, overloaded)))
    return runs


def tenant_view(fleet):
    return {name: {k: v for k, v in st.items() if k != "tier"}
            for name, st in fleet.tenant_stats().items()}


class TestFleet:
    def test_specs_validate_as_jax(self):
        port_fs, jax_fs = fleet_specs()
        assert port_fs.pool_specs()[2].name == port_fs.pipelines[0].name
        assert port_fs.tier_of("bulk").name == "tiny-b"
        for bad in (dict(name=""), dict(slo_ms=-1.0),
                    dict(max_inflight=0)):
            fields = {**dict(name="t", tier="tier"), **bad}
            with pytest.raises(ValueError) as mine:
                TenantSpec(**fields)
            with pytest.raises(ValueError) as theirs:
                JaxTenantSpec(**fields)
            assert str(mine.value) == str(theirs.value)
        for make in (lambda fs, ts, s: fs(pipelines=()),
                     lambda fs, ts, s: fs(pipelines=(s, s)),
                     lambda fs, ts, s: fs(pipelines=(s,), tenants=(
                         ts("t", "nowhere"),)),
                     lambda fs, ts, s: fs(pipelines=(s,), tenants=(
                         ts("t", s.name), ts("t", s.name))),
                     lambda fs, ts, s: fs(pipelines=(s,), replicas=0)):
            msgs = []
            for fs, ts, s in ((FleetSpec, TenantSpec, serving_port()),
                              (JaxFleetSpec, JaxTenantSpec, serving_jax())):
                with pytest.raises(ValueError) as exc:
                    make(fs, ts, s)
                msgs.append(str(exc.value))
            assert msgs[0] == msgs[1]
        with pytest.raises(UnknownKeyError, match="RPA006.*least-loaded"):
            port_fs.replace(router="nope").validate()
        with pytest.raises(KeyError, match="RPA006"):
            jax_fs.replace(router="nope").validate()

    def test_pool_shares_and_refuses(self, pools, params_np):
        pool = pools[0]
        assert pool[0] is pool[2] and pool[1] is pool[3]
        assert pool[0] is not pool[1]
        with pytest.raises(KeyError, match="no params"):
            build_pool(fleet_specs()[0].pool_specs(), {}, device="cpu")
        # a sharded pool: its default mesh needs CUDA devices; on a mesh,
        # each replica gets its own pipeline on its own row
        sharded = serving_port(data_shards=2)
        by_name = {sharded.name: from_numpy_tree(params_np)}
        with pytest.raises(ValueError, match=r"2 x 2 replica x data mesh "
                                             r"needs 4 CUDA devices"):
            build_pool([sharded] * 2, by_name, device="cpu")
        spool = build_pool([sharded] * 2, by_name, mesh=make_mesh2d(
            2, 2, devices=("cpu",) * 4))
        assert spool[0] is not spool[1]
        assert [p.mesh.shape for p in spool] == [{"data": 2}] * 2
        fs = fleet_specs()[0]
        with pytest.raises(ValueError, match="pool order"):
            PipelineFleet(list(reversed(pool)), fs)
        with pytest.raises(ValueError, match="replicas"):
            PipelineFleet(pool[:1], fs)

    @pytest.mark.parametrize("router_name", ["least-loaded", "round-robin",
                                             "sticky"])
    @pytest.mark.parametrize("shape", ["steady", "bursty"])
    def test_routing_matches_jax_and_solo(self, pools, clouds, clean, solo,
                                          router_name, shape):
        by_tenant = {"rt": clouds[:5], "bulk": clouds[5:]}
        trace = (fleet_steady_trace(by_tenant, gap_ms=4.0)
                 if shape == "steady" else
                 fleet_bursty_trace(by_tenant, burst=3))
        (fleet, adm, shed, place), (jfleet, jadm, jshed, jplace) = \
            run_fleets(pools, trace,
                       lambda fs: fs.replace(router=router_name))
        assert not shed and not jshed and len(adm) == len(clouds)
        assert place == jplace                  # the same replica choices
        assert [f.latency_ms for _, f in adm] == [
            f.latency_ms for _, f in jadm]
        assert tenant_view(fleet) == tenant_view(jfleet)
        assert fleet.pending == 0
        for arrival, fut in adm:
            assert bitwise(fut.result(), solo(arrival.cloud))
        idx = [next(i for i, c in enumerate(clouds) if c is a.cloud)
               for a, _ in adm]
        assert_close([f.result() for _, f in adm],
                     [f.result() for _, f in jadm], [clean[i] for i in idx])

    def test_overload_sheds_as_jax(self, pools, clouds, solo):
        def bulkheads(fs):
            return fs.replace(tenants=tuple(
                t.replace(max_inflight=3 if t.name == "rt" else 5)
                for t in fs.tenants))
        trace = fleet_overload_trace({"rt": clouds[:4],
                                      "bulk": clouds[4:8]}, repeat=3)
        (fleet, adm, shed, place), (jfleet, jadm, jshed, jplace) = \
            run_fleets(pools, trace, bulkheads)
        assert shed and len(adm) + len(shed) == len(trace)
        assert [(a.tenant, e.reason, str(e)) for a, e in shed] == [
            (a.tenant, e.reason, str(e)) for a, e in jshed]
        assert all(isinstance(e, admission.Overloaded) for _, e in shed)
        assert place == jplace
        assert tenant_view(fleet) == tenant_view(jfleet)
        assert fleet.stats()["shed"] == len(shed) == jfleet.stats()["shed"]
        assert fleet.tenant_stats()["rt"]["shed"] == 4 * 3 - 3
        for arrival, fut in adm:
            assert bitwise(fut.result(), solo(arrival.cloud))

    def test_slo_shed_with_a_calibrated_cost_model(self, pools, clouds):
        def sticky_rt(fs):
            return fs.replace(router="sticky", tenants=(
                fs.tenants[0].replace(slo_ms=15.0),))

        def hold(fleet):
            for rep in fleet.replicas:
                rep.engine.policy = _StubCost(10.0)
                rep.engine.policy.decide = lambda **kw: 0

        trace = [Arrival(0.0, clouds[0], "rt"), Arrival(0.0, clouds[1], "rt")]
        (fleet, adm, shed, _), (_, jadm, jshed, _) = run_fleets(
            pools, trace, sticky_rt, hold)
        assert len(adm) == len(jadm) == 1
        assert [(e.reason, e.estimated_ms) for _, e in shed] == [
            (e.reason, e.estimated_ms) for _, e in jshed] == [("slo", 20.0)]
        assert fleet.tenants["rt"].shed == 1 and adm[0][1].done()

    def test_fleet_surface(self, pools, clouds, params_np, monkeypatch):
        fspec = fleet_specs()[0]
        fleet = PipelineFleet(pools[0], fspec, seed=SEED,
                              clock=VirtualClock())
        with pytest.raises(KeyError, match="bulk, rt"):
            fleet.submit("nobody", clouds[0])
        for c in clouds[:4]:
            fleet.submit("rt", c)
        assert [r.engine.pending for r in fleet.replicas] == [2, 0, 2, 0]
        assert fleet.warmup() > 0 and fleet.calibrate() == 0
        fleet.flush()
        text = fleet.describe()
        for needle in ("tiny-b", "rt", "bulk", "least-loaded", "cpu"):
            assert needle in text
        fleet.reset_stats()
        assert fleet.stats()["requests"] == 0
        assert fleet.tenant_stats()["rt"]["p50_ms"] is None
        with pytest.raises(ValueError, match="stream=True"):
            fleet.open_stream("rt")
        fleet.close()
        with pytest.raises(RuntimeError, match="closed"):
            fleet.submit("rt", clouds[0])

        async def scenario():
            # the fixed policy holds a lone request until close() flushes
            f = PipelineFleet(pools[0], fspec, seed=SEED)
            server = asyncio.create_task(f.serve_loop(tick_s=1e-4))
            answer = asyncio.ensure_future(f.classify_async("bulk",
                                                            clouds[0]))
            await asyncio.sleep(0)
            f.close()
            await server
            return await asyncio.wait_for(answer, 60)
        out = asyncio.run(scenario())
        batch, _ = pad_to_batch(torch.from_numpy(clouds[0][None]), MAX_BATCH)
        want, _ = pools[0][1].infer(batch,
                                    pools[0][1].seed_state(SEED, MAX_BATCH))
        assert bitwise(out, want[0])

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        params = {p.name: from_numpy_tree(params_np)
                  for p in fspec.pipelines}
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PipelineFleet.from_specs(fspec, params)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            AsyncPointCloudEngine.from_params(params["tiny-b"],
                                              fspec.pipelines[1])
        assert len(PipelineFleet.from_specs(fspec, params,
                                            device="cpu").replicas) == 4
