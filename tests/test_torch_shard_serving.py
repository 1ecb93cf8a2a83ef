"""The port's sharded point-cloud dispatch (``repro_torch.serve.sharding``).

A spec with ``data_shards = n`` splits every dispatch into n contiguous
blocks of lanes, one a device of a ``("data",)`` mesh.  On the CPU the
mesh repeats the CPU (``devices=("cpu",) * n``), the port's counterpart
of the JAX package's forced host devices.  At the tiny size of
``tests/test_sharded_dispatch.py`` (128 points, embed 16, k = 8; BN
statistics perturbed), for the three variants of its ``VARIANTS`` (fp32
on ``ref``, fp32 on the port's kernel backend, which runs the kernels'
plain versions on CPU tensors, and int8 on ``ref``):

* golden: the sharded logits and advanced LFSR state are bitwise the
  unsharded port's, at 2, 4 and 8 shards, directly, through both engines,
  a stream session (a miss, then hits) and a 2 x 4 replica x data fleet;
* the unsharded port against ``repro.api.build(spec, params).infer``
  on the port's frozen tree (both packages then hold identical weights,
  int8 codes included): the LFSR state exactly, the kNN mapping exactly
  on the lanes compared (a near-tie swap is reported and its lane left
  out), and logits within 1e-4 of max|logit| for every variant.  In int8
  the products are exact and only the normalization sigma differs by
  about an ulp between the packages; an activation pushed across a
  rounding boundary would move its lane by a whole int8 step and fail
  that bound, and the failure names the lane.  JAX's own tests hold
  JAX's sharded dispatch to its unsharded one;
* the refusals of ``tests/test_sharded_dispatch.py`` and
  ``tests/serving/test_fleet.py``, with the port's recipe (``devices=``)
  where JAX's names ``XLA_FLAGS``.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from repro.api.build import build as jax_build
from repro.api.spec import lite_spec as jax_lite_spec
from repro.core import knn as jknn
from repro.core import sampling as jsampling
from repro_torch.api.build import build, build_pool
from repro_torch.api.spec import FleetSpec, TenantSpec, lite_spec
from repro_torch.core import knn as tknn
from repro_torch.core import sampling as tsampling
from repro_torch.kernels import _build
from repro_torch.models.pointmlp import pointmlp_init
from repro_torch.serve import sharding
from repro_torch.serve.async_engine import AsyncPointCloudEngine
from repro_torch.serve.batching import pad_to_batch
from repro_torch.serve.fleet import PipelineFleet
from repro_torch.serve.pointcloud import PointCloudEngine
from repro_torch.serve.sharding import (make_mesh, make_mesh2d,
                                        replica_submesh, shard_forward)
from repro_torch.serve.streaming import StreamSession, replay_reference
from repro_torch.sharding import context
from repro_torch.tune.search import quick_space
from test_torch_kernels import assert_knn_match, sqdist64

TINY = dict(n_points=128, embed_dim=16, k_neighbors=8)
SEED = 7
B = 8
RTOL = 1e-4
VARIANTS = {
    "fp32_ref": dict(precision="fp32", backend="ref"),
    "kernels": dict(precision="fp32", backend="cuda"),
    "int8": dict(precision="int8", backend="ref"),
}
#: JAX's backend of each variant: the port's ``cuda`` is its ``pallas``.
JAX_BACKEND = {"fp32_ref": "ref", "kernels": "pallas_interpret",
               "int8": "ref"}


def spec(variant, **over):
    return lite_spec(8).replace(**TINY, **VARIANTS[variant]).serving(
    ).replace(**over)


def cpus(n):
    return ("cpu",) * n


def sharded(variant, n, params, **over):
    return build(spec(variant, data_shards=n, **over), params,
                 mesh=make_mesh(n, devices=cpus(n)))


@pytest.fixture(scope="module")
def clouds():
    return np.random.default_rng(2).standard_normal(
        (12, TINY["n_points"], 3)).astype(np.float32)


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


@pytest.fixture(scope="module")
def params():
    """Per variant: the port's frozen tree of one raw init (a seeded
    generator; BN statistics perturbed from a numpy seed, so the fold is
    not an identity)."""
    raw = pointmlp_init(spec("fp32_ref").to_model_config(),
                        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)

    def perturb(node):
        if isinstance(node, dict):
            if "bn" in node:
                c = node["bn"]["gamma"].shape[0]
                node["bn"] = {k: torch.from_numpy(v.astype(np.float32))
                              for k, v in (
                                  ("gamma", rng.uniform(0.7, 1.3, c)),
                                  ("beta", 0.1 * rng.standard_normal(c)),
                                  ("mean", 0.1 * rng.standard_normal(c)),
                                  ("var", rng.uniform(0.5, 1.5, c)))}
            for v in node.values():
                perturb(v)
        elif isinstance(node, list):
            for v in node:
                perturb(v)
    perturb(raw)
    return {name: build(spec(name), raw, device="cpu").params
            for name in VARIANTS}


@pytest.fixture(scope="module")
def jax_runs(params, clouds):
    """Per variant: JAX's logits and advanced state on the first B clouds,
    from one jitted build of the port's frozen tree each."""
    out = {}
    for name, over in VARIANTS.items():
        pipe = jax_build(jax_lite_spec(8).replace(
            **TINY, **dict(over, backend=JAX_BACKEND[name])).serving(),
            tree_map(lambda t: jnp.asarray(t.numpy()), params[name]))
        logits, state = pipe.infer(clouds[:B],
                                   jsampling.seed_streams(SEED, B))
        out[name] = (np.asarray(logits), np.asarray(state))
    return out


def clean_lanes(pts):
    """The lanes whose mapping (URS from the seed state, then kNN at every
    stage) both packages compute alike; a near-tie swap is reported."""
    j_state = jsampling.seed_streams(SEED, pts.shape[0])
    t_state = tsampling.seed_streams(SEED, pts.shape[0])
    j_cur, t_cur = jnp.asarray(pts), torch.from_numpy(pts)
    ok = np.ones(pts.shape[0], bool)
    for n_samp in spec("fp32_ref").to_model_config().stage_samples:
        j_state, j_idx = jsampling.urs_indices(j_state, j_cur.shape[1],
                                               n_samp)
        t_state, t_idx = tsampling.urs_indices(t_state, t_cur.shape[1],
                                               n_samp)
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
        j_new = j_cur[:, np.asarray(j_idx)]
        t_new = tsampling.gather_points(
            t_cur, t_idx[None].expand(pts.shape[0], -1))
        j_nbr = np.asarray(jknn.knn_batched(j_new, j_cur, TINY[
            "k_neighbors"]))
        t_nbr = tknn.knn_batched(t_new, t_cur, TINY["k_neighbors"]).numpy()
        assert_knn_match(t_nbr, j_nbr,
                         sqdist64(t_new.numpy(), t_cur.numpy()))
        ok &= (t_nbr == j_nbr).all(axis=(1, 2))
        j_cur, t_cur = j_new, t_new
    assert ok.sum() >= pts.shape[0] - 1, "near-tie swaps in most lanes"
    return ok


def rigid_frames(seed, n, cut_at):
    """``n`` frames of one cloud, each the last turned by 0.0015 rad
    about z and shifted by 0.002 of a normal draw, with a cut of +1.0 in
    x before frame ``cut_at``."""
    rng = np.random.default_rng(seed)
    cur = rng.standard_normal((TINY["n_points"], 3)).astype(np.float32)
    c, s = np.cos(0.0015), np.sin(0.0015)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    frames = []
    for i in range(n):
        if i == cut_at:
            cur = cur + np.float32([1.0, 0.0, 0.0])
        frames.append(cur.astype(np.float32))
        cur = cur @ rot.T + 0.002 * rng.standard_normal(3).astype(
            np.float32)
    return frames


@pytest.fixture(scope="module")
def base(params, clouds):
    """Per variant: the unsharded port pipeline and its (logits, state)
    on the first B clouds."""
    out = {}
    for name in VARIANTS:
        pipe = build(spec(name), params[name], device="cpu")
        out[name] = (pipe, pipe.infer(clouds[:B],
                                      pipe.seed_state(SEED, B)))
    return out


def assert_bitwise(got, want, what):
    assert got.shape == want.shape and torch.equal(got, want), what


# ------------------------------------------------------------ golden --

class TestGolden:
    @pytest.mark.parametrize("n", [2, 4, 8])
    @pytest.mark.parametrize("variant", sorted(VARIANTS))
    def test_infer_bitwise_unsharded(self, variant, n, params, base, clouds):
        pipe = sharded(variant, n, params[variant])
        assert pipe.mesh.shape == {"data": n}
        assert f"{n}-way data-parallel" in pipe.describe()
        want, wstate = base[variant][1]
        got, gstate = pipe.infer(clouds[:B], pipe.seed_state(SEED, B))
        assert got.device == torch.device("cpu")
        assert_bitwise(got, want, f"{variant} logits at {n} shards")
        assert_bitwise(gstate, wstate, f"{variant} state at {n} shards")

    @pytest.mark.parametrize("variant", sorted(VARIANTS))
    def test_unsharded_port_matches_jax(self, variant, base, jax_runs,
                                        clouds):
        want, jstate = jax_runs[variant]
        got, state = (t.numpy() for t in base[variant][1])
        np.testing.assert_array_equal(state, jstate.astype(np.int64))
        lanes = clean_lanes(clouds[:B])
        scale = np.abs(want).max()
        off = [int(i) for i in np.flatnonzero(lanes) if not np.allclose(
            got[i], want[i], rtol=RTOL, atol=RTOL * scale)]
        assert not off, (f"{variant}: lanes {off} differ from JAX by more "
                         f"than {RTOL} of max|logit| (an int8 activation "
                         f"across a rounding boundary moves a whole step)")

    def test_per_lane_urs_splits_the_streams(self, params, clouds):
        """Per-lane URS: lane b draws from stream b, so the streams split
        with the lanes and concatenate again."""
        one = build(spec("int8", shared_urs=False), params["int8"],
                    device="cpu")
        pipe = sharded("int8", 4, params["int8"], shared_urs=False)
        state = one.seed_state(SEED, B)
        want, wstate = one.infer(clouds[:B], state)
        got, gstate = pipe.infer(clouds[:B], state)
        assert_bitwise(got, want, "per-lane logits")
        assert_bitwise(gstate, wstate, "per-lane state")
        assert not torch.equal(gstate[0].expand(B), gstate)

    def test_params_copied_once_a_distinct_device(self, params):
        pipe = sharded("fp32_ref", 4, params["fp32_ref"])
        assert pipe.mesh.distinct_devices() == [torch.device("cpu")]
        assert list(pipe.shard_params) == [torch.device("cpu")]
        assert pipe.params is pipe.shard_params[torch.device("cpu")]
        one = build(spec("fp32_ref"), params["fp32_ref"], device="cpu")
        assert one.mesh is None and one.shard_params is None
        assert "sharding  : single-device" in one.describe()


# ----------------------------------------------------- serving paths --

class TestServingPaths:
    @pytest.mark.parametrize("variant", sorted(VARIANTS))
    def test_sync_engine(self, variant, params, clouds):
        """A ragged 12-cloud queue (2 dispatches, 4 pad lanes): logits and
        the engine's threaded state bitwise."""
        one = PointCloudEngine(params[variant], spec(variant), max_batch=B,
                               seed=SEED, device="cpu")
        eng = PointCloudEngine(params[variant], spec(variant, data_shards=8),
                               max_batch=B, seed=SEED,
                               mesh=make_mesh(8, devices=cpus(8)))
        assert eng.device == torch.device("cpu")
        assert_bitwise(eng.classify(clouds), one.classify(clouds), variant)
        assert_bitwise(eng.lfsr_state, one.lfsr_state, variant)

    @pytest.mark.parametrize("variant", sorted(VARIANTS))
    def test_async_engine(self, variant, params, clouds):
        def serve(n):
            mesh = make_mesh(n, devices=cpus(n)) if n > 1 else None
            eng = AsyncPointCloudEngine.from_params(
                params[variant], spec(variant, data_shards=n),
                device=None if mesh else "cpu", mesh=mesh, max_batch=B,
                policy="fixed", seed=SEED)
            futures = [eng.submit(c) for c in clouds]
            while eng.pump():
                pass
            eng.flush()
            return torch.stack([f.result() for f in futures])
        assert_bitwise(serve(8), serve(1), variant)

    def test_stream_session(self, params):
        """Collect, then cached: a direct session on a 4-shard streaming
        pipeline (4 lanes, one a shard) against the unsharded session and
        the stateless reference, frame for frame; hits as unsharded."""
        over = dict(stream=True, stream_drift_threshold=0.05)
        one = build(spec("int8", **over), params["int8"], device="cpu")
        pipe = sharded("int8", 4, params["int8"], **over)
        frames = rigid_frames(3, n=6, cut_at=4)
        s1 = StreamSession(one, seed=SEED)
        s4 = StreamSession(pipe, seed=SEED)
        for i, frame in enumerate(frames):
            assert_bitwise(s4.infer(frame), s1.infer(frame), f"frame {i}")
        assert s4.stats.hits == s1.stats.hits > 0
        assert s4.stats.misses == s1.stats.misses > 1
        ref = replay_reference(pipe, frames, seed=SEED)
        for i, (got, want) in enumerate(zip(ref, replay_reference(
                one, frames, seed=SEED))):
            assert_bitwise(got, want, f"reference frame {i}")

    def test_async_stream_session(self, params):
        over = dict(stream=True, stream_drift_threshold=0.05)
        frames = rigid_frames(4, n=4, cut_at=3)

        def serve(n):
            mesh = make_mesh(n, devices=cpus(n)) if n > 1 else None
            eng = AsyncPointCloudEngine.from_params(
                params["fp32_ref"], spec("fp32_ref", data_shards=n, **over),
                device=None if mesh else "cpu", mesh=mesh, max_batch=4,
                seed=SEED)
            sess = eng.open_stream()
            outs = []
            for frame in frames:
                fut = sess.submit(frame)
                eng.flush()
                outs.append(fut.result())
            return torch.stack(outs), sess.stats.hits
        got, hits = serve(4)
        want, want_hits = serve(1)
        assert_bitwise(got, want, "async stream frames")
        assert hits == want_hits > 0

    def test_fleet_replica2_data4(self, params, clouds):
        """A 2 replica x 4 shard fleet on a repeated-CPU mesh answers each
        tenant bitwise as its tier's unsharded pipeline alone."""
        s4 = spec("int8", name="tiny-s4", data_shards=4)
        fspec = FleetSpec(
            pipelines=(s4,),
            tenants=(TenantSpec("rt", "tiny-s4", slo_ms=0.0),
                     TenantSpec("bulk", "tiny-s4", slo_ms=0.0)),
            replicas=2, max_batch=4)
        fleet = PipelineFleet.from_specs(
            fspec, {"tiny-s4": params["int8"]}, seed=SEED,
            mesh=make_mesh2d(2, 4, devices=cpus(8)))
        pipes = [rep.engine.pipeline for rep in fleet.replicas]
        assert pipes[0] is not pipes[1]
        assert all(p.mesh.shape == {"data": 4} for p in pipes)
        assert "devices ['cpu', 'cpu', 'cpu', 'cpu']" in fleet.describe()
        futs = [(c, fleet.submit(t, c)) for c in clouds[:8]
                for t in ("rt", "bulk")]
        fleet.flush()
        solo = build(spec("int8", name="tiny-s4"), params["int8"],
                     device="cpu")
        for c, fut in futs:
            batch, _ = pad_to_batch(torch.from_numpy(c[None]), 4)
            want, _ = solo.infer(batch, solo.seed_state(SEED, 4))
            assert_bitwise(fut.result(), want[0], "fleet request")
        assert {rep.engine.stats.batches > 0 for rep in fleet.replicas} \
            == {True}


# -------------------------------------------------------- validation --

class TestValidation:
    def test_default_mesh_needs_cuda_devices(self, params):
        have = torch.cuda.device_count()
        with pytest.raises(ValueError, match=r"devices=\('cpu',\)"):
            make_mesh(have + 1)
        with pytest.raises(ValueError, match=r"replica x data mesh needs"):
            make_mesh2d(have + 1, 1)
        with pytest.raises(ValueError, match="CUDA devices"):
            build(spec("fp32_ref", data_shards=max(2, have + 1)),
                  params["fp32_ref"], device="cpu")
        with pytest.raises(ValueError, match="takes 4 devices, got 3"):
            make_mesh(4, devices=cpus(3))

    def test_mesh_axes_and_submeshes(self):
        mesh = make_mesh2d(2, 4, devices=cpus(8))
        assert mesh.axis_names == ("replica", "data")
        assert mesh.devices.shape == (2, 4) and mesh.size == 8
        assert mesh.shape == {"replica": 2, "data": 4}
        for r in range(2):
            sub = replica_submesh(mesh, r)
            assert sub.axis_names == ("data",) and sub.devices.shape == (4,)
        with pytest.raises(ValueError, match="out of range"):
            replica_submesh(mesh, 2)
        with pytest.raises(ValueError, match="'replica', 'data'"):
            replica_submesh(make_mesh(2, devices=cpus(2)), 0)
        with pytest.raises(ValueError, match="do not name"):
            sharding.LocalMesh(np.array(["cpu"] * 4, dtype=object),
                               ("replica", "data"))

    def test_uneven_batch_and_engine_shapes(self, params, clouds):
        pipe = sharded("fp32_ref", 8, params["fp32_ref"])
        with pytest.raises(ValueError, match="data_shards=8 must divide"):
            pipe.infer(clouds[:6], pipe.seed_state(SEED, 6))
        # the engines refuse before any mesh is made
        with pytest.raises(ValueError, match="data_shards=3 must divide"):
            PointCloudEngine(params["fp32_ref"],
                             spec("fp32_ref", data_shards=3), max_batch=4,
                             device="cpu")
        with pytest.raises(ValueError, match="data_shards=8 must divide"):
            AsyncPointCloudEngine(pipe, max_batch=12)

    def test_rpa020_and_per_lane_streams(self, params, clouds):
        bad = spec("fp32_ref", data_shards=2).replace(per_sample_norm=False)
        with pytest.raises(ValueError, match="RPA020.*per-sample"):
            build(bad, params["fp32_ref"], mesh=make_mesh(2, cpus(2)))
        with pytest.raises(ValueError, match="RPA020"):
            shard_forward(lambda *a: a, bad, make_mesh(2, cpus(2)))
        pipe = sharded("fp32_ref", 8, params["fp32_ref"], shared_urs=False)
        with pytest.raises(ValueError, match="one stream per lane"):
            pipe.infer(clouds[:B], pipe.seed_state(SEED, 16))
        # per-lane URS takes one W8A8 activation scale per dispatch,
        # which a split would make one per shard
        one = build(spec("int8", backend="cuda", shared_urs=False),
                    params["int8"], device="cpu")
        full, _ = one.infer(clouds[:B], one.seed_state(SEED, B))
        half, _ = one.infer(clouds[:B // 2], one.seed_state(SEED, B // 2))
        assert not torch.equal(full[:B // 2], half)
        with pytest.raises(ValueError, match="one scale per dispatch"):
            sharded("int8", 2, params["int8"], backend="cuda",
                    shared_urs=False)
        for over in (dict(stage_precision=("fp32",) * 3 + ("int8",)),
                     dict(precision="fp32", stage_precision=("int8",) * 4)):
            with pytest.raises(ValueError, match="one scale per dispatch"):
                sharded("fp32_ref", 2, params["int8"], backend="cuda",
                        shared_urs=False, **over)

    def test_mesh_context_installed_and_restored(self, params, clouds):
        seen = []

        def fwd(p, pts, lfsr):
            seen.append(context.current_mesh())
            return pts[:, 0, :], lfsr
        s2 = spec("fp32_ref", data_shards=2)
        mesh = make_mesh(2, cpus(2))
        dispatch, got_mesh = shard_forward(fwd, s2, mesh)
        assert got_mesh is mesh
        out, _ = dispatch({torch.device("cpu"): None},
                          torch.from_numpy(clouds[:4]), None)
        assert seen == [mesh, mesh] and out.shape == (4, 3)
        assert context.current_mesh() is None
        sentinel = object()
        pipe = sharded("fp32_ref", 8, params["fp32_ref"])
        with context.use_mesh(sentinel):
            with pytest.raises(ValueError, match="data_shards"):
                pipe.infer(clouds[:6], pipe.seed_state(SEED, 6))
            assert context.current_mesh() is sentinel
        assert context.current_mesh() is None
        with pytest.raises(ValueError, match="1-D \\('data',\\) mesh"):
            shard_forward(fwd, s2, make_mesh(4, cpus(4)))

    def test_build_placement_refusals(self, params):
        p = params["fp32_ref"]
        with pytest.raises(ValueError, match="no mesh to place on"):
            build(spec("fp32_ref"), p, mesh=make_mesh(2, cpus(2)))
        with pytest.raises(ValueError, match="first device is cpu"):
            build(spec("fp32_ref", data_shards=2), p, device="meta",
                  mesh=make_mesh(2, cpus(2)))
        s2 = spec("fp32_ref", data_shards=2)
        with pytest.raises(ValueError, match="agree on data_shards"):
            build_pool([s2, spec("fp32_ref")], {s2.name: p})
        with pytest.raises(ValueError, match="one row per pool spec"):
            build_pool([s2] * 2, {s2.name: p},
                       mesh=make_mesh2d(3, 2, devices=cpus(6)))
        with pytest.raises(ValueError, match="one row per pool spec"):
            build_pool([s2] * 2, {s2.name: p}, mesh=make_mesh(2, cpus(2)))
        with pytest.raises(ValueError, match="pool is unsharded"):
            build_pool([spec("fp32_ref")], {s2.name: p},
                       mesh=make_mesh2d(1, 2, devices=cpus(2)))

    def test_quick_space_shards_as_jax(self, monkeypatch):
        """JAX's rule: {1, min(8, n)} with two or more devices."""
        base = lite_spec(40).serving()
        for n, want in ((0, {1}), (1, {1}), (4, {1, 4}), (16, {1, 8})):
            monkeypatch.setattr(torch.cuda, "device_count", lambda n=n: n)
            assert {s.data_shards for s in quick_space(base)} == want


def test_launch_sets_the_tensors_device(monkeypatch):
    """A wrapper's launch runs with the tensor's device current: the CUDA
    runtime launches on the current device whatever stream it is given
    (on one card the fault cannot show, so the order is checked here)."""
    calls = []

    class Device:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            calls.append(("enter", self.dev))

        def __exit__(self, *exc):
            calls.append(("exit", self.dev))

    def current_stream(dev):
        calls.append(("stream", dev))
        return types.SimpleNamespace(cuda_stream=1234)

    def fake_launch(*args):
        calls.append(("launch", args))
        return 0

    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(_build, "launcher", lambda name: fake_launch)
    dev = torch.device("cuda", 1)
    _build.launch("knn", dev, 7, 8)
    assert calls == [("enter", dev), ("stream", dev),
                     ("launch", (7, 8, 1234)), ("exit", dev)]
    monkeypatch.setattr(_build, "launcher", lambda name: lambda *a: 9)
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        _build.launch("knn", dev)
