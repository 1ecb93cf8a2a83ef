"""Parity of the port's stream sessions (``repro_torch.serve.streaming``) with ``repro.serve.streaming``.

The same frames (drifting clouds from ``np.random.default_rng``: each a
small rigid motion of the last, with a scene cut) and the same parameters
(drawn by ``repro.models.pointmlp.pointmlp_init``, BN perturbed from a
numpy seed) go through both packages at the tiny serving spec of
``tests/serving/harness.py`` (128 points, embed 16, k = 8, fp32), on the
JAX side with its ``ref`` backend and on the port's with the plain
versions on the CPU.

* Cache decisions (hit, miss, eviction; the drift metric is numpy on both
  sides) are identical, frame by frame.
* Within the port every frame is bitwise equal to ``replay_reference``,
  through the direct session, the sync engine's, the async engine's and
  the fleet's.
* Against JAX, logits agree within 1e-4 of max|logit| (rtol 1e-4): float32
  sums in another order over the 15 layers, as in ``test_torch_pipeline``.
  A frame whose (key frame's) neighbour lists differ by a reported
  near-tie kNN swap between the packages is left out of that comparison.
"""
import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "serving"))
from harness import (TINY, VirtualClock, run_stream_trace,  # noqa: E402
                     stream_burst_reset, stream_steady, tiny_serving_spec)

from repro.api.build import build as jax_build  # noqa: E402
from repro.core import knn as jknn  # noqa: E402
from repro.core import sampling as jsampling  # noqa: E402
from repro.models import pointmlp as JPM  # noqa: E402
from repro.serve.async_engine import \
    AsyncPointCloudEngine as JaxAsync  # noqa: E402
from repro.serve.streaming import StreamSession as JaxSession  # noqa: E402
from repro_torch.api import registry  # noqa: E402
from repro_torch.api.build import build, build_pool  # noqa: E402
from repro_torch.api.spec import (FleetSpec, TenantSpec,  # noqa: E402
                                  lite_spec)
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.core import knn as tknn  # noqa: E402
from repro_torch.core import sampling as tsampling  # noqa: E402
from repro_torch.kernels import fps as fps_mod  # noqa: E402
from repro_torch.kernels import knn as knn_mod  # noqa: E402
from repro_torch.serve.async_engine import AsyncPointCloudEngine  # noqa
from repro_torch.serve.fleet import PipelineFleet  # noqa: E402
from repro_torch.serve.pointcloud import PointCloudEngine  # noqa: E402
from repro_torch.serve.streaming import (StreamSession,  # noqa: E402
                                         replay_reference)
from test_torch_kernels import assert_knn_match, sqdist64  # noqa: E402

SEED = 7
THRESH = 0.05
RTOL = 1e-4
N_FRAMES = 16
CUT_AT = 8

#: The spec overrides of each variant held against JAX, the same in both
#: packages.  Lite's W8A8 lowering (the port's ``cuda`` backend) runs in
#: JAX only in Pallas interpret mode; ``TestW8A8`` holds it within the port.
VARIANTS = {
    "fp32": dict(precision="fp32", backend="ref"),
    "int8-w8": dict(precision="int8", backend="ref"),
}


def port_spec(**over):
    over.setdefault("stream", True)
    over.setdefault("stream_drift_threshold", THRESH)
    fields = dict(precision="fp32", backend="ref", **TINY)
    fields.update(over)
    return lite_spec(8).replace(**fields).serving()


def jax_spec(**over):
    over.setdefault("stream", True)
    over.setdefault("stream_drift_threshold", THRESH)
    return tiny_serving_spec(**over)


def rigid_frames(seed, n=N_FRAMES, cut_at=CUT_AT, n_points=TINY["n_points"],
                 angle=0.0015, shift=0.002):
    """``n`` frames, each a rotation about z by ``angle`` and a shift of
    the last (about 0.006 of displacement a frame for these clouds, so a
    few frames in a row stay within THRESH of their key frame), with a
    cut of +1.0 in x before frame ``cut_at``."""
    rng = np.random.default_rng(seed)
    cur = rng.standard_normal((n_points, 3)).astype(np.float32)
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    frames = []
    for i in range(n):
        if i == cut_at:
            cur = cur + np.array([1.0, 0.0, 0.0], np.float32)
        frames.append(cur.astype(np.float32))
        cur = cur @ rot.T + shift * rng.standard_normal(3).astype(np.float32)
    return frames


def perturbed_params(head="cls"):
    """A raw JAX parameter tree as numpy, BN statistics perturbed."""
    cfg = jax_spec(head=head).to_model_config()
    params = jax.tree_util.tree_map(
        np.asarray, JPM.pointmlp_init(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(1)

    def perturb(node):
        if isinstance(node, dict):
            if "bn" in node:
                c = node["bn"]["gamma"].shape[0]
                node["bn"] = {
                    "gamma": rng.uniform(0.7, 1.3, c).astype(np.float32),
                    "beta": (0.1 * rng.standard_normal(c)).astype(np.float32),
                    "mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
            for v in node.values():
                perturb(v)
        elif isinstance(node, list):
            for v in node:
                perturb(v)
    perturb(params)
    return params


def jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def mapping_matches(frame, k=TINY["k_neighbors"]):
    """Whether both packages map ``frame`` alike on the cold path (URS
    from the seed state, then kNN at every stage); a near-tie swap is
    reported and gives False."""
    j_state = jsampling.seed_streams(SEED, 1)
    t_state = tsampling.seed_streams(SEED, 1)
    j_cur = jnp.asarray(frame[None])
    t_cur = torch.from_numpy(frame[None])
    same = True
    for n_samp in port_spec().to_model_config().stage_samples:
        j_state, j_idx = jsampling.urs_indices(j_state, j_cur.shape[1],
                                               n_samp)
        t_state, t_idx = tsampling.urs_indices(t_state, t_cur.shape[1],
                                               n_samp)
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
        j_new = j_cur[:, np.asarray(j_idx)]
        t_new = tsampling.gather_points(t_cur, t_idx[None])
        j_nbr = np.asarray(jknn.knn_batched(j_new, j_cur, k))
        t_nbr = tknn.knn_batched(t_new, t_cur, k).numpy()
        same &= assert_knn_match(t_nbr, j_nbr, sqdist64(
            t_new.numpy(), t_cur.numpy())) == 0
        j_cur, t_cur = j_new, t_new
    return same


def hit_flags(session, frames, resets=()):
    """Serve ``frames`` through a direct session (either package): the
    per-frame logits as numpy and whether each frame was a cache hit."""
    outs, hits = [], []
    for i, f in enumerate(frames):
        if i in resets:
            session.reset()
        before = session.stats.hits
        outs.append(np.asarray(session.infer(f)))
        hits.append(session.stats.hits > before)
    return outs, hits


def key_frames(hits):
    """The key frame each frame's mapping comes from."""
    keys, key = [], None
    for i, hit in enumerate(hits):
        key = key if hit else i
        keys.append(key)
    return keys


def bitwise(a, b) -> bool:
    a = a.cpu() if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.asarray(a))
    b = b.cpu() if isinstance(b, torch.Tensor) else torch.from_numpy(
        np.asarray(b))
    return a.shape == b.shape and torch.equal(a, b)


def assert_close_to_jax(got, want, clean):
    """Frames ``clean[i]`` held to RTOL of the whole run's max|logit|."""
    assert sum(clean) >= len(clean) - 2, "near-tie swaps in most frames"
    scale = max(np.abs(w).max() for w in want)
    for i, ok in enumerate(clean):
        if ok:
            np.testing.assert_allclose(got[i], want[i], rtol=RTOL,
                                       atol=RTOL * scale,
                                       err_msg=f"frame {i}")


@pytest.fixture(scope="module")
def params_np():
    return perturbed_params()


@pytest.fixture(scope="module")
def frames():
    return rigid_frames(3)


@pytest.fixture(scope="module")
def clean(frames):
    return [mapping_matches(f) for f in frames]


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant(request):
    return request.param


@pytest.fixture(scope="module")
def pipes(variant, params_np):
    """(port pipeline, JAX pipeline) of one variant."""
    over = VARIANTS[variant]
    assert (dataclasses.asdict(port_spec(**over))
            == dataclasses.asdict(jax_spec(**over)))
    return (build(port_spec(**over), from_numpy_tree(params_np),
                  device="cpu"),
            jax_build(jax_spec(**over), jax_tree(params_np)))


@pytest.fixture(scope="module")
def w8a8_pipe(params_np):
    """Lite's W8A8 lowering on the CPU (the plain int8 product)."""
    return build(port_spec(precision="int8", backend="cuda"),
                 from_numpy_tree(params_np), device="cpu")


# ------------------------------------------------------- the contract --

class TestDirectSession:
    def test_matches_jax_and_replay(self, pipes, frames, clean):
        port, jax_pipe = pipes
        got, hits = hit_flags(StreamSession(port, seed=SEED), frames)
        want, jax_hits = hit_flags(JaxSession(jax_pipe, seed=SEED), frames)
        assert hits == jax_hits
        assert 0 < sum(hits) < len(frames) - 2     # both paths exercised
        assert not hits[0] and not hits[CUT_AT]    # the scene cut misses
        ref = replay_reference(port, frames, seed=SEED)
        for i in range(len(frames)):
            assert bitwise(got[i], ref[i]), f"frame {i}"
        keys = key_frames(hits)
        assert_close_to_jax(got, want, [clean[keys[i]]
                                        for i in range(len(frames))])

    def test_collect_pass_is_infer_bit_for_bit(self, pipes, frames):
        port, _ = pipes
        pts = np.stack(frames[:4])
        state = port.seed_state(SEED, 4)
        want, w_state = port.infer(pts, state.clone())
        got, g_state, cache = port.infer_collect(pts, state.clone())
        assert torch.equal(got, want) and torch.equal(g_state, w_state)
        assert set(cache) == {"sample", "nbr"}
        assert [tuple(n.shape) for n in cache["nbr"]] == [
            (4, s, TINY["k_neighbors"])
            for s in port.model_config.stage_samples]
        # replaying a frame's own cache is the cold pass again
        again, _ = port.infer_cached(pts, state.clone(), cache)
        assert torch.equal(again, want)

    def test_reset_and_eviction_match_jax(self, pipes, frames):
        port, jax_pipe = pipes
        resets = (3, 11)
        for max_age in (None, 2):
            sess = StreamSession(port, seed=SEED, max_age=max_age)
            jsess = JaxSession(jax_pipe, seed=SEED, max_age=max_age)
            got, hits = hit_flags(sess, frames, resets)
            _, jax_hits = hit_flags(jsess, frames, resets)
            assert hits == jax_hits
            assert dataclasses.asdict(sess.stats) == dataclasses.asdict(
                jsess.stats)
            assert sess.stats.resets == len(resets)
            ref = replay_reference(port, frames, seed=SEED,
                                   max_age=max_age, resets=resets)
            for i in range(len(frames)):
                assert bitwise(got[i], ref[i]), f"max_age {max_age} {i}"
        assert sess.stats.evictions > 0

    def test_sync_engine_session_ignores_queue_traffic(self, pipes, frames,
                                                       params_np):
        port, _ = pipes
        eng = PointCloudEngine(from_numpy_tree(params_np), port.spec,
                               max_batch=4, seed=SEED, device="cpu")
        sess = eng.open_stream()
        ref = replay_reference(port, frames, seed=SEED)
        for i, f in enumerate(frames):
            out = sess.infer(f)
            if i == 2:                      # queue traffic between frames
                eng.classify(np.stack(frames[:3]))
            assert bitwise(out, ref[i]), f"frame {i}"


class TestW8A8:
    """Lite's deployment (the port's ``cuda`` backend, here the plain
    int8 product): every transport bitwise equal to the reference, and
    the same decisions as the fp32 session (they are host-side)."""

    def test_transports_bitwise(self, w8a8_pipe, frames, params_np):
        ref = replay_reference(w8a8_pipe, frames, seed=SEED)
        direct, hits = hit_flags(StreamSession(w8a8_pipe, seed=SEED),
                                 frames)
        clock = VirtualClock()
        eng = AsyncPointCloudEngine(w8a8_pipe, max_batch=4, policy="fixed",
                                    seed=SEED, clock=clock)
        sessions = [eng.open_stream(), eng.open_stream()]
        trace = stream_steady(frames, session=0) + stream_steady(
            frames, start_ms=1.0, session=1)
        futs = run_stream_trace(eng, sessions, trace, clock)
        fleet_spec = FleetSpec(
            pipelines=(w8a8_pipe.spec.replace(name="lite-stream"),),
            tenants=(TenantSpec("rt", "lite-stream", slo_ms=0.0),),
            replicas=2, max_batch=4)
        pool = build_pool(fleet_spec.pool_specs(),
                          {"lite-stream": from_numpy_tree(params_np)},
                          device="cpu")
        fclock = VirtualClock()
        fleet = PipelineFleet(pool, fleet_spec, seed=SEED, clock=fclock)
        fsess = fleet.open_stream("rt")
        ffuts = run_stream_trace(fleet, [fsess], stream_steady(frames),
                                 fclock)[0]
        for i in range(len(frames)):
            assert bitwise(direct[i], ref[i]), f"direct {i}"
            for s in range(2):
                assert bitwise(futs[s][i].result(), ref[i]), f"async {s} {i}"
            assert bitwise(ffuts[i].result(), ref[i]), f"fleet {i}"
        assert sum(hits) > 0
        for sess in (*sessions, fsess):
            assert sess.stats.hits == sum(hits)
        assert fleet.tenants["rt"].submitted == len(frames)


class TestAsyncTransport:
    def test_burst_reset_trace_matches_jax(self, pipes, frames, clean):
        """Two sessions and plain requests share dispatches: identical
        decisions, dispatches and virtual-clock latencies on both sides;
        the port's frames bitwise to its reference."""
        port, jax_pipe = pipes
        trace, resets = stream_burst_reset(frames, burst=5)
        reset_idx = tuple(i for (_, i) in resets)
        runs = {}
        for name, pipe, eng_cls in (("port", port, AsyncPointCloudEngine),
                                    ("jax", jax_pipe, JaxAsync)):
            clock = VirtualClock()
            eng = eng_cls(pipe, max_batch=4, policy="deadline", seed=SEED,
                          clock=clock)
            eng.policy.slo_ms = 3.0
            sess = eng.open_stream()
            plain = [eng.submit(frames[0])]
            futs = run_stream_trace(eng, [sess], trace, clock,
                                    resets=resets)[0]
            plain.append(eng.submit(frames[1]))
            eng.flush()
            runs[name] = (futs, plain, sess.stats, eng.stats)
        p_futs, p_plain, p_sstats, p_stats = runs["port"]
        j_futs, j_plain, j_sstats, j_stats = runs["jax"]
        assert dataclasses.asdict(p_sstats) == dataclasses.asdict(j_sstats)
        assert (p_stats.batches, p_stats.padded, p_stats.requests) == (
            j_stats.batches, j_stats.padded, j_stats.requests)
        assert [f.latency_ms for f in p_futs + p_plain] == [
            f.latency_ms for f in j_futs + j_plain]
        ref = replay_reference(port, frames, seed=SEED, resets=reset_idx)
        for i, fut in enumerate(p_futs):
            assert bitwise(fut.result(), ref[i]), f"frame {i}"
        cold = [replay_reference(port, [f], seed=SEED)[0]
                for f in frames[:2]]
        for fut, want in zip(p_plain, cold):
            assert bitwise(fut.result(), want)
        assert p_sstats.resets == len(reset_idx) and p_sstats.hits > 0

    def test_one_frame_in_flight(self, pipes, frames):
        port, _ = pipes
        eng = AsyncPointCloudEngine(port, max_batch=4, policy="fixed",
                                    seed=SEED, clock=VirtualClock())
        sess = eng.open_stream()
        sess.submit(frames[0])
        with pytest.raises(RuntimeError, match="in flight"):
            sess.submit(frames[1])
        eng.flush()
        sess.submit(frames[1])
        eng.flush()
        assert sess.stats.hits == 1

    def test_hit_runs_and_miss_runs_never_mix(self, pipes, frames):
        """A dispatch is all cache replays or none: a hit queued behind a
        plain request waits for the next dispatch."""
        port, _ = pipes
        eng = AsyncPointCloudEngine(port, max_batch=4, policy="fixed",
                                    seed=SEED, clock=VirtualClock())
        sess = eng.open_stream()
        sess.submit(frames[0])
        eng.flush()
        eng.submit(frames[5])
        hit = sess.submit(frames[1])
        eng.submit(frames[6])
        eng.flush()
        assert eng.stats.batches == 4 and hit.done()
        assert bitwise(hit.result(),
                       replay_reference(port, frames[:2], seed=SEED)[1])


class TestFleetTransport:
    def test_fleet_stream_matches_jax(self, pipes, frames, params_np, clean):
        from repro.api import FleetSpec as JaxFleetSpec
        from repro.api import TenantSpec as JaxTenantSpec
        from repro.api import build_pool as jax_build_pool
        from repro.serve.fleet import PipelineFleet as JaxFleet
        port, jax_pipe = pipes
        runs = {}
        for name, fs_cls, ts_cls, pool_fn, fleet_cls, spec, params, kw in (
                ("port", FleetSpec, TenantSpec, build_pool, PipelineFleet,
                 port.spec, from_numpy_tree(params_np), {"device": "cpu"}),
                ("jax", JaxFleetSpec, JaxTenantSpec, jax_build_pool,
                 JaxFleet, jax_pipe.spec, jax_tree(params_np), {})):
            fspec = fs_cls(pipelines=(spec.replace(name="tier"),),
                           tenants=(ts_cls("rt", "tier", slo_ms=0.0),),
                           replicas=2, max_batch=4)
            pool = pool_fn(fspec.pool_specs(), {"tier": params}, **kw)
            assert pool[0] is pool[1]       # replicas share one pipeline
            clock = VirtualClock()
            fleet = fleet_cls(pool, fspec, seed=SEED, clock=clock)
            sess = fleet.open_stream("rt")
            futs = run_stream_trace(fleet, [sess], stream_steady(frames),
                                    clock)[0]
            runs[name] = ([np.asarray(f.result()) for f in futs],
                          [f.latency_ms for f in futs], sess.stats,
                          fleet.tenants["rt"].submitted)
        got, p_lat, p_stats, p_sub = runs["port"]
        want, j_lat, j_stats, j_sub = runs["jax"]
        assert p_lat == j_lat and p_sub == j_sub == len(frames)
        assert dataclasses.asdict(p_stats) == dataclasses.asdict(j_stats)
        ref = replay_reference(port, frames, seed=SEED)
        for i in range(len(frames)):
            assert bitwise(got[i], ref[i]), f"frame {i}"
        _, hits = hit_flags(StreamSession(port, seed=SEED), frames)
        keys = key_frames(hits)
        assert_close_to_jax(got, want, [clean[keys[i]]
                                        for i in range(len(frames))])


class TestSegHead:
    @pytest.fixture(scope="class")
    def seg(self):
        params = perturbed_params(head="seg")
        return (build(port_spec(head="seg"), from_numpy_tree(params),
                      device="cpu"),
                jax_build(jax_spec(head="seg"), jax_tree(params)))

    def test_seg_stream_matches_jax_and_replay(self, seg, frames, clean):
        port, jax_pipe = seg
        got, hits = hit_flags(StreamSession(port, seed=SEED), frames)
        want, jax_hits = hit_flags(JaxSession(jax_pipe, seed=SEED), frames)
        assert hits == jax_hits and sum(hits) > 0
        assert got[0].shape == (TINY["n_points"], 8)
        ref = replay_reference(port, frames, seed=SEED)
        for i in range(len(frames)):
            assert bitwise(got[i], ref[i]), f"frame {i}"
        keys = key_frames(hits)
        assert_close_to_jax(got, want, [clean[keys[i]]
                                        for i in range(len(frames))])

    def test_seg_cache_holds_the_upsample_and_async_agrees(self, seg,
                                                           frames):
        port, _ = seg
        _, _, cache = port.infer_collect(np.stack(frames[:2]),
                                         port.seed_state(SEED, 2))
        assert tuple(cache["up"].shape) == (2, TINY["n_points"], 1)
        ref = replay_reference(port, frames[:6], seed=SEED)
        eng = AsyncPointCloudEngine(port, max_batch=4, policy="fixed",
                                    seed=SEED, clock=VirtualClock())
        sess = eng.open_stream()
        for i, f in enumerate(frames[:6]):
            fut = sess.submit(f)
            eng.flush()
            assert bitwise(fut.result(), ref[i]), f"frame {i}"


# ------------------------------------------------------ mapping split --

class TestMappingSplit:
    @pytest.mark.parametrize("grouper", ["knn", "ball"])
    def test_group_with_idx_is_the_whole_grouper(self, grouper):
        g = registry.GROUPERS.get(grouper)
        rng = np.random.default_rng(5)
        xyz = torch.from_numpy(rng.standard_normal((3, 64, 3))
                               .astype(np.float32))
        feats = torch.from_numpy(rng.standard_normal((3, 64, 16))
                                 .astype(np.float32))
        idx = torch.from_numpy(rng.integers(0, 64, (3, 32)))
        want = g(xyz, feats, idx, 8, None, "norm", True)
        nbr = g.neighbor_index(tsampling.gather_points(xyz, idx), xyz, 8)
        got = g.group_with_idx(xyz, feats, idx, nbr, None, "norm", True)
        for a, b in zip(got, want):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("sampler", ["fps", "urs"])
    def test_a_hit_runs_no_mapping_op(self, params_np, frames, sampler,
                                      monkeypatch):
        """A cache hit calls neither kNN nor (for FPS, whose
        ``advances_state`` is False) the sampler; URS still walks."""
        pipe = build(port_spec(sampler=sampler), from_numpy_tree(params_np),
                     device="cpu")
        calls = {"knn": 0, "fps": 0}

        def counting(name, fn):
            def wrapped(*a, **kw):
                calls[name] += 1
                return fn(*a, **kw)
            return wrapped

        monkeypatch.setattr(knn_mod, "knn", counting("knn", knn_mod.knn))
        monkeypatch.setattr(fps_mod, "fps", counting("fps", fps_mod.fps))
        sess = StreamSession(pipe, seed=SEED)
        sess.infer(frames[0])
        assert calls == {"knn": 4, "fps": 4 if sampler == "fps" else 0}
        calls.update(knn=0, fps=0)
        sess.infer(frames[1])
        assert sess.stats.hits == 1 and calls == {"knn": 0, "fps": 0}
        assert registry.SAMPLERS.get(sampler).advances_state is (
            sampler == "urs")


class TestLifecycle:
    def test_requires_streaming_pipeline(self, params_np):
        pipe = build(port_spec(stream=False), from_numpy_tree(params_np),
                     device="cpu")
        assert not pipe.streaming
        with pytest.raises(ValueError, match="RPA030.*stream=True"):
            StreamSession(pipe, seed=SEED)
        eng = AsyncPointCloudEngine(pipe, max_batch=4, seed=SEED)
        with pytest.raises(ValueError, match="stream=True"):
            eng.open_stream()
        with pytest.raises(ValueError, match="streaming pipeline"):
            pipe.infer_collect(np.zeros((1, 128, 3), np.float32))

    def test_frame_shape_checked(self, pipes):
        sess = StreamSession(pipes[0], seed=SEED)
        with pytest.raises(ValueError, match=r"one \[N="):
            sess.infer(np.zeros((3, 3), np.float32))

    def test_session_options_checked(self, pipes):
        with pytest.raises(ValueError, match="max_age"):
            StreamSession(pipes[0], max_age=0)
        with pytest.raises(ValueError, match="positive multiple"):
            StreamSession(pipes[0], batch=0)

    def test_describe_tags_stream_stages(self, pipes):
        assert "[stream-cached mapping]" in pipes[0].describe()


# -------------------------------------------------- a random schedule --

@settings(max_examples=8, deadline=None, derandomize=True,
          suppress_health_check=list(HealthCheck))
@given(
    steps=st.lists(st.sampled_from([0.0, 0.004, 0.02, 0.3]), min_size=2,
                   max_size=7),
    resets=st.sets(st.integers(0, 7), max_size=2),
    max_age=st.sampled_from([None, 1, 2, 3]))
def test_random_drift_reset_eviction_schedule(params_np, steps, resets,
                                              max_age):
    """A drawn schedule of per-frame shifts (some within the threshold,
    some past it), resets and an eviction age: the port's session is
    bitwise its reference, and its decisions are JAX's."""
    pipe = _hypothesis_pipes(params_np)
    base = rigid_frames(11, n=1)[0]
    frames, cur = [base], base
    for step in steps:
        cur = (cur + np.float32(step)).astype(np.float32)
        frames.append(cur)
    resets = tuple(sorted(r for r in resets if r < len(frames)))
    got, hits = hit_flags(StreamSession(pipe[0], seed=SEED, max_age=max_age),
                          frames, resets)
    _, jax_hits = hit_flags(JaxSession(pipe[1], seed=SEED, max_age=max_age),
                            frames, resets)
    assert hits == jax_hits
    ref = replay_reference(pipe[0], frames, seed=SEED, max_age=max_age,
                           resets=resets)
    for i in range(len(frames)):
        assert bitwise(got[i], ref[i]), f"frame {i}"


_HYPOTHESIS_PIPES = {}


def _hypothesis_pipes(params_np):
    """The fp32 pair, built once (hypothesis calls the test many times)."""
    if not _HYPOTHESIS_PIPES:
        _HYPOTHESIS_PIPES["p"] = (
            build(port_spec(), from_numpy_tree(params_np), device="cpu"),
            jax_build(jax_spec(), jax_tree(params_np)))
    return _HYPOTHESIS_PIPES["p"]
