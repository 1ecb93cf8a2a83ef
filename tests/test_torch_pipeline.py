"""End-to-end parity of the port's pipeline (``repro_torch``) with ``repro.api``.

The same parameters (drawn by ``repro.models.pointmlp.pointmlp_init``,
with BN statistics perturbed from a numpy seed so the fold is not an
identity) and the same clouds (``np.random.default_rng``) go through
``repro.api.build(..., jit=False)`` and the port's ``build(...,
device="cpu")`` at the tiny size of ``tests/test_kernel_tuning.py``
(128 points, embed 16, k=8).  Where the JAX side exports int8, its frozen
parameters are carried into the port, so the int8 weights are identical.

First the mapping is compared: URS indices exactly, per-stage kNN indices
exactly apart from reported near-tie swaps (JAX forms the kNN cross term
with a dot product, the port elementwise; see ``test_torch_kernels``).
Logits are compared on the lanes whose mapping matched, with these
tolerances:

* every comparison: rtol 1e-4, atol 1e-4 * max|logit|.  In fp32 (M-2,
  and Lite's W8 dequantized ``ref`` path) float32 sums over K <= 256 are
  taken in another order and compound over the 15 layers of the walk.
  In W8A8 (Lite on the port's ``cuda`` backend against JAX's
  ``pallas_interpret``) the int8 products and their dequantization are
  bitwise equal; only the normalization sigma differs by about an ulp
  (JAX sums its mean in float32, the port in float64), which moves the
  next layer's activation scale by an ulp.  An activation pushed across a
  rounding tie would move by a whole int8 step (1/127 of its lane's
  absmax) and fail this bound; these inputs have none.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.build import build as jax_build
from repro.api.spec import PipelineSpec as JaxSpec
from repro.api.spec import elite_spec as jax_elite_spec
from repro.api.spec import lite_spec as jax_lite_spec
from repro.api.spec import m2_spec as jax_m2_spec
from repro.core import knn as jknn
from repro.core import sampling as jsampling
from repro.models import pointmlp as JPM
from repro_torch.api import plan as tplan
from repro_torch.api.build import build
from repro_torch.api.spec import PipelineSpec, elite_spec, lite_spec, m2_spec
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_numpy_tree
from repro_torch.core import knn as tknn
from repro_torch.core import sampling as tsampling
from repro_torch.data import lm_data
from repro_torch.data.pointclouds import make_batch
from repro_torch.kernels.tuning import DEFAULT_TUNING, KernelTuning
from repro_torch.launch import train as lm_train
from repro_torch.models import pointmlp as TPM
from repro_torch.models.api import get_model
from repro_torch.serve.batching import pad_to_batch
from repro_torch.serve.engine import Engine as LMEngine
from repro_torch.serve.pointcloud import PointCloudEngine
from repro_torch.train.pointmlp import train_eval
from test_torch_kernels import assert_knn_match, sqdist64

TINY = dict(n_points=128, embed_dim=16, k_neighbors=8)
B = 4
SEED = 7
RTOL = 1e-4


def tiny(spec_fn, **over):
    return spec_fn(8, **TINY).replace(**over).serving()


@pytest.fixture(scope="module")
def raw_params():
    """A raw (BN-carrying) JAX parameter tree as numpy, BN perturbed."""
    cfg = tiny(jax_m2_spec).to_model_config()
    init = jax.jit(JPM.pointmlp_init, static_argnums=1)  # one compile
    params = jax.tree_util.tree_map(np.asarray,
                                    init(jax.random.PRNGKey(0), cfg))
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


@pytest.fixture(scope="module")
def clouds():
    return np.random.default_rng(2).standard_normal(
        (B, TINY["n_points"], 3)).astype(np.float32)


@pytest.fixture(scope="module")
def lanes(clouds):
    return clean_lanes(clouds)


@pytest.fixture(scope="module")
def jax_lite_ref(raw_params, clouds):
    """JAX's Lite ``ref`` run on ``clouds``: (logits, state, frozen)."""
    return run_jax(tiny(jax_lite_spec), raw_params, clouds)


def jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def run_jax(spec, params_np, pts):
    pipe = jax_build(spec, jax_tree(params_np), jit=False)
    logits, state = pipe.infer(jnp.asarray(pts),
                               jsampling.seed_streams(SEED, pts.shape[0]))
    frozen = jax.tree_util.tree_map(np.asarray, pipe.params)
    return np.asarray(logits), np.asarray(state), frozen


def run_port(spec, params_np, pts):
    pipe = build(spec, from_numpy_tree(params_np), device="cpu")
    logits, state = pipe.infer(torch.from_numpy(pts),
                               pipe.seed_state(SEED, pts.shape[0]))
    return logits.numpy(), state.numpy()


def clean_lanes(pts, k=TINY["k_neighbors"]):
    """Compare the mapping chains of both packages; return the lanes whose
    kNN indices matched exactly (near-tie swaps are reported)."""
    j_state = jsampling.seed_streams(SEED, pts.shape[0])
    t_state = tsampling.seed_streams(SEED, pts.shape[0])
    j_cur, t_cur = jnp.asarray(pts), torch.from_numpy(pts)
    ok = np.ones(pts.shape[0], bool)
    for n_samp in tiny(m2_spec).to_model_config().stage_samples:
        j_state, j_idx = jsampling.urs_indices(j_state, j_cur.shape[1],
                                               n_samp)
        t_state, t_idx = tsampling.urs_indices(t_state, t_cur.shape[1],
                                               n_samp)
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
        j_new = j_cur[:, np.asarray(j_idx)]
        t_new = tsampling.gather_points(
            t_cur, t_idx[None].expand(pts.shape[0], -1))
        j_nbr = np.asarray(jknn.knn_batched(j_new, j_cur, k))
        t_nbr = tknn.knn_batched(t_new, t_cur, k).numpy()
        assert_knn_match(t_nbr, j_nbr,
                         sqdist64(t_new.numpy(), t_cur.numpy()))
        ok &= (t_nbr == j_nbr).all(axis=(1, 2))
        j_cur, t_cur = j_new, t_new
    np.testing.assert_array_equal(t_state.numpy(),
                                  np.asarray(j_state).astype(np.int64))
    assert ok.sum() >= pts.shape[0] - 1, "near-tie swaps in most lanes"
    return ok


def assert_logits_close(got, want, lanes):
    np.testing.assert_allclose(got[lanes], want[lanes], rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


# ------------------------------------------------------------- parity --

class TestParityWithJax:
    def test_m2_fp32_ref(self, raw_params, clouds, lanes):
        want, j_state, _ = run_jax(tiny(jax_m2_spec), raw_params, clouds)
        got, t_state = run_port(tiny(m2_spec), raw_params, clouds)
        assert got.shape == (B, 8) and np.isfinite(got).all()
        assert_logits_close(got, want, lanes)
        np.testing.assert_array_equal(t_state, j_state.astype(np.int64))

    def test_m2_fp32_cuda_backend_on_cpu(self, raw_params, clouds, lanes):
        """The port's kernel backend runs fused_linear's plain version on
        CPU tensors; JAX's runs the Pallas kernel in interpret mode."""
        want, _, _ = run_jax(tiny(jax_m2_spec, backend="pallas_interpret"),
                             raw_params, clouds)
        got, _ = run_port(tiny(m2_spec, backend="cuda"), raw_params, clouds)
        assert_logits_close(got, want, lanes)

    def test_lite_w8a8_cuda_vs_pallas_interpret(self, raw_params, clouds,
                                                lanes):
        want, j_state, frozen = run_jax(
            tiny(jax_lite_spec, backend="pallas_interpret"), raw_params,
            clouds)
        assert frozen["embed"]["w"]["q"].dtype == np.int8
        got, t_state = run_port(tiny(lite_spec, backend="cuda"), frozen,
                                clouds)
        assert np.isfinite(got).all()
        assert_logits_close(got, want, lanes)
        np.testing.assert_array_equal(t_state, j_state.astype(np.int64))

    def test_lite_w8_ref(self, jax_lite_ref, clouds, lanes):
        want, _, frozen = jax_lite_ref
        got, _ = run_port(tiny(lite_spec), frozen, clouds)
        assert_logits_close(got, want, lanes)

    def test_stage_precision_mix(self, raw_params, clouds, lanes):
        mix = ("int8", "int8", "int8", "fp32")
        want, _, frozen = run_jax(
            tiny(jax_lite_spec, backend="pallas_interpret",
                 stage_precision=mix), raw_params, clouds)
        assert not isinstance(frozen["stages"][3]["transfer"]["w"], dict)
        assert isinstance(frozen["stages"][2]["transfer"]["w"], dict)
        got, _ = run_port(tiny(lite_spec, backend="cuda",
                               stage_precision=mix), frozen, clouds)
        assert_logits_close(got, want, lanes)

    def test_flops_and_plan_match(self):
        jspec, tspec = tiny(jax_lite_spec), tiny(lite_spec)
        jcfg, tcfg = jspec.to_model_config(), tspec.to_model_config()
        assert TPM.pointmlp_flops_breakdown(tcfg) == \
            JPM.pointmlp_flops_breakdown(jcfg)
        plan = tplan.lower(tspec, tcfg)
        assert len(plan.cbr_ops()) == 27        # + head fc3 = 28 layers
        assert TPM.count_conv_layers(tcfg) == JPM.count_conv_layers(jcfg)


# ------------------------------------------------------------ weights --

class TestConvert:
    def test_raw_tree_keeps_structure(self, raw_params):
        tree = from_numpy_tree(raw_params)
        flat_np = jax.tree_util.tree_flatten_with_path(raw_params)[0]
        flat_t = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]
        assert [p for p, _ in flat_np] == [p for p, _ in flat_t]
        for (_, a), (_, b) in zip(flat_np, flat_t):
            assert b.dtype == torch.float32
            np.testing.assert_array_equal(b.numpy(), a)

    def test_port_freeze_matches_jax_freeze(self, raw_params, jax_lite_ref):
        """The port fuses and exports a raw tree as JAX does: fused fp32
        weights to rtol 1e-6, int8 codes within one step on at most 0.1%
        of the weights (an ulp of rsqrt can tip a code at a tie)."""
        spec = tiny(lite_spec)
        jfrozen = jax_lite_ref[2]
        tfrozen = build(spec, from_numpy_tree(raw_params),
                        device="cpu").params
        jleaves = jax.tree_util.tree_flatten_with_path(jfrozen)[0]
        tleaves = dict(jax.tree_util.tree_flatten_with_path(
            tfrozen, is_leaf=lambda x: isinstance(x, torch.Tensor))[0])
        off, total = 0, 0
        for path, a in jleaves:
            b = tleaves[path].numpy()
            assert b.dtype == a.dtype
            if a.dtype == np.int8:
                diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
                assert diff.max() <= 1
                off, total = off + int((diff > 0).sum()), total + a.size
            else:
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
        assert off <= 1e-3 * total

    def test_frozen_tree_passes_through_build(self, jax_lite_ref):
        frozen = jax_lite_ref[2]
        pipe = build(tiny(lite_spec), from_numpy_tree(frozen), device="cpu")
        q = pipe.params["stages"][1]["pre"][0]["net1"]["w"]["q"]
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(
            q.numpy(), frozen["stages"][1]["pre"][0]["net1"]["w"]["q"])

    def test_rejects_non_numpy_leaves(self):
        with pytest.raises(TypeError, match="np.asarray"):
            from_numpy_tree({"w": jnp.ones((2, 2))})


# ------------------------------------------------------------- engine --

class TestEngine:
    @pytest.fixture(scope="class")
    def lite_frozen(self, jax_lite_ref):
        return jax_lite_ref[2]

    def test_ragged_queue_matches_pipeline(self, lite_frozen):
        spec = tiny(lite_spec, backend="cuda")
        params = from_numpy_tree(lite_frozen)
        queue = np.random.default_rng(4).standard_normal(
            (7, 128, 3)).astype(np.float32)
        eng = PointCloudEngine(params, spec, max_batch=4, seed=SEED,
                               device="cpu")
        got = eng.classify(list(queue))
        assert got.shape == (7, 8)
        assert (eng.stats.requests, eng.stats.batches,
                eng.stats.padded) == (7, 2, 1)
        assert eng.stats.serve_s > 0 and eng.stats.host_s > 0
        pipe = build(spec, params, device="cpu")
        state = pipe.seed_state(SEED, 4)
        first, state = pipe.infer(torch.from_numpy(queue[:4]), state)
        tail, _ = pad_to_batch(torch.from_numpy(queue[4:]), 4)
        second, state = pipe.infer(tail, state)
        assert torch.equal(got, torch.cat([first, second[:3]]))
        assert torch.equal(eng.lfsr_state, state)
        assert eng.predict(queue[:2]).shape == (2,)
        assert "max_batch : 4" in eng.describe()

    @pytest.mark.parametrize("spec_fn,backend", [(lite_spec, "cuda"),
                                                 (lite_spec, "ref"),
                                                 (m2_spec, "cuda")])
    def test_pad_lanes_do_not_leak(self, lite_frozen, raw_params, spec_fn,
                                   backend):
        """A lane's logits are the same alone in a zero-padded dispatch and
        inside a full one (serving semantics, one dispatch shape)."""
        tree = lite_frozen if spec_fn is lite_spec else raw_params
        pipe = build(tiny(spec_fn, backend=backend), from_numpy_tree(tree),
                     device="cpu")
        full = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (B, 128, 3)).astype(np.float32))
        alone, _ = pad_to_batch(full[2:3], B)
        state = pipe.seed_state(SEED, B)
        a, _ = pipe.infer(full, state)
        b, _ = pipe.infer(alone, state)
        if spec_fn is lite_spec and backend == "cuda":
            assert torch.equal(a[2], b[0])  # every product integer-exact
        else:
            torch.testing.assert_close(a[2], b[0], rtol=1e-5, atol=1e-5)

    def test_warmup_keeps_state_and_empty_queue(self, lite_frozen):
        eng = PointCloudEngine(from_numpy_tree(lite_frozen),
                               tiny(lite_spec, backend="cuda"), max_batch=2,
                               device="cpu")
        before = eng.lfsr_state
        assert eng.warmup() > 0
        assert torch.equal(eng.lfsr_state, before)
        assert eng.classify(np.zeros((0, 128, 3))).shape == (0, 8)
        with pytest.raises(ValueError, match="fixed-shape"):
            eng.classify(np.zeros((2, 64, 3)))


# --------------------------------------------------------------- spec --

class TestSpecAndDevice:
    def test_fields_mirror_jax_spec(self):
        jf = [(f.name, f.default) for f in dataclasses.fields(JaxSpec)]
        tf = [(f.name, f.default) for f in dataclasses.fields(PipelineSpec)]
        assert tf == jf

    def test_variant_helpers_mirror_jax(self):
        for t_fn, j_fn in ((lite_spec, jax_lite_spec),
                           (m2_spec, jax_m2_spec),
                           (elite_spec, jax_elite_spec)):
            assert (dataclasses.asdict(t_fn(10).serving())
                    == dataclasses.asdict(j_fn(10).serving()))
            assert dataclasses.asdict(t_fn(10)) == dataclasses.asdict(j_fn(10))
        assert elite_spec().sampler == "fps"

    @pytest.mark.parametrize("over,item", [
        (dict(data_shards=2), "sharded"),
        (dict(kernel_tuning=KernelTuning(knn=12)), "Tuning"),
    ])
    def test_unported_values_name_their_roadmap_item(self, raw_params, over,
                                                     item):
        """Both values are ported, so each refusal names what to pass
        instead: a sharded spec's default mesh needs as many CUDA devices
        as shards, and the refusal gives the ``devices=`` recipe (a CPU
        mesh repeats the CPU); a tile the card lacks (kNN's query tile is
        a multiple of 8) is a ValueError naming the tiles it has."""
        want = {"sharded": (ValueError, r"data_shards=2 needs 2 CUDA "
                                        r"devices but only \d+ are "
                                        r"available.*devices=\('cpu',\) "
                                        r"\* 2"),
                "Tuning": (ValueError, "knn: the card has no tile 12; it "
                                       "has queries a block in multiples "
                                       "of 8")}[item]
        with pytest.raises(want[0], match=want[1]):
            build(tiny(m2_spec, **over), from_numpy_tree(raw_params),
                  device="cpu")

    @pytest.mark.parametrize("over,shape", [
        (dict(grouper="ball"), (B, 8)),
        (dict(head="seg"), (B, 128, 8)),
    ])
    def test_ball_and_seg_build_and_infer(self, raw_params, clouds, over,
                                          shape):
        """The `ball` grouper and the seg head, once refused here, now
        build and infer on the CPU (their parity with JAX is in
        ``test_torch_ladder``)."""
        if "head" in over:
            cfg = tiny(m2_spec, **over).to_model_config()
            params = TPM.pointmlp_init(cfg, torch.Generator().manual_seed(0))
        else:
            params = from_numpy_tree(raw_params)
        pipe = build(tiny(m2_spec, **over), params, device="cpu")
        logits, _ = pipe.infer(clouds, pipe.seed_state(SEED, B))
        assert logits.shape == shape and bool(torch.isfinite(logits).all())

    def test_stream_spec_builds_and_infers(self, raw_params, clouds):
        """A stream spec, once refused here, builds and infers; its
        collect pass gives infer's logits bit for bit (sessions and
        their parity with JAX are in ``test_torch_streaming``)."""
        pipe = build(tiny(m2_spec, stream=True, stream_drift_threshold=0.05),
                     from_numpy_tree(raw_params), device="cpu")
        assert pipe.streaming and pipe.plan.stream
        logits, _ = pipe.infer(clouds, pipe.seed_state(SEED, B))
        assert logits.shape == (B, 8) and bool(torch.isfinite(logits).all())
        again, _, cache = pipe.infer_collect(clouds, pipe.seed_state(SEED, B))
        assert torch.equal(again, logits) and len(cache["nbr"]) == 4

    @pytest.mark.parametrize("over,exc,match", [
        (dict(grouper="ball"), ValueError, r"RPA010.*grouper='ball'"),
        (dict(precision="int8"), ValueError, r"RPA011.*fp32"),
        (dict(fuse=False), ValueError, r"RPA012.*fuse=True"),
        (dict(stream=True), ValueError, r"RPA013.*fused_group='none'"),
    ])
    def test_fused_group_rejections(self, raw_params, over, exc, match):
        """The fused group->transfer lowering's preconditions (the JAX
        package's RPA010-012: the kNN grouper, fp32 transfers, folded BN)
        name the field to change; so does RPA013, the stream lowering's
        refusal of a fused group."""
        spec = tiny(m2_spec, fused_group="grouped_transfer", **over)
        with pytest.raises(exc, match=f"(?s){match}"):
            build(spec, from_numpy_tree(raw_params), device="cpu")

    @pytest.mark.parametrize("rule", ["RPA014", "RPA015", "RPA005"])
    def test_stream_and_policy_rules(self, raw_params, rule):
        """The stream-cache contract (a grouper with the neighbor_index /
        group_with_idx split, RPA014; a sampler declaring advances_state,
        RPA015) and the batch-policy key (RPA005, which only the spec's
        ``validate`` and the engines check, as in JAX) name the field to
        change."""
        from repro_torch.api import registry

        def bare_grouper(xyz, feats, idx, k, affine, mode, per_sample):
            raise AssertionError("never called")

        def bare_sampler(xyz, n, state, shared):
            raise AssertionError("never called")

        registry.register_grouper("_bare_grouper")(bare_grouper)
        registry.register_sampler("_bare_sampler")(bare_sampler)
        try:
            over, match = {
                "RPA014": (dict(grouper="_bare_grouper"),
                           r"RPA014.*grouper='knn'"),
                "RPA015": (dict(sampler="_bare_sampler"),
                           r"RPA015.*sampler='fps' or 'urs'"),
                "RPA005": (dict(policy="nope"), r"RPA005.*set policy"),
            }[rule]
            spec = tiny(m2_spec, stream=rule != "RPA005",
                        stream_drift_threshold=0.05, **over)
            with pytest.raises(ValueError, match=match):
                spec.validate()
            if rule == "RPA005":
                assert build(spec, from_numpy_tree(raw_params),
                             device="cpu").streaming is False
            else:
                with pytest.raises(ValueError, match=match):
                    build(spec, from_numpy_tree(raw_params), device="cpu")
        finally:
            registry.GROUPERS.unregister("_bare_grouper")
            registry.SAMPLERS.unregister("_bare_sampler")

    def test_unknown_fused_group_lists_registered(self, raw_params):
        with pytest.raises(KeyError, match="grouped_transfer"):
            build(tiny(m2_spec, fused_group="nope"),
                  from_numpy_tree(raw_params), device="cpu")

    def test_default_tuning_is_accepted(self, raw_params):
        pipe = build(tiny(m2_spec, kernel_tuning=DEFAULT_TUNING),
                     from_numpy_tree(raw_params), device="cpu")
        assert pipe.plan.cbr_ops()

    def test_unknown_backend_lists_registered(self, raw_params):
        with pytest.raises(KeyError, match="cuda, ref"):
            build(tiny(m2_spec, backend="pallas"),
                  from_numpy_tree(raw_params), device="cpu")

    def test_default_device_needs_a_gpu(self, raw_params, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        params = from_numpy_tree(raw_params)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(tiny(m2_spec), params)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PointCloudEngine(params, tiny(m2_spec))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_eval(tiny(m2_spec).to_model_config(), steps=1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_batch(0, 0, 128, 2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lm_data.synth_batch(0, 0, 2, 8, 512)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(lm_data.stream(0, 2, 8, 512))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lm_train.main(["--arch", "tinyllama-1.1b", "--smoke",
                           "--steps", "1"])
        for arch in ("xlstm-1.3b", "hymba-1.5b", "whisper-tiny"):
            api = get_model(get_smoke_config(arch))
            with pytest.raises(RuntimeError, match="no CUDA device"):
                api.init(torch.Generator().manual_seed(0))
            with pytest.raises(RuntimeError, match="no CUDA device"):
                api.init_cache(1, 8)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                LMEngine(api, {}, max_len=8, batch_size=1)

    def test_short_lfsr_state_rejected(self, raw_params, clouds):
        pipe = build(tiny(m2_spec), from_numpy_tree(raw_params),
                     device="cpu")
        with pytest.raises(ValueError, match="streams for a batch"):
            pipe.infer(clouds, pipe.seed_state(0, 2))
        assert "fp32" in pipe.describe() and pipe.flops() > 0

    def test_port_imports_neither_jax_nor_repro(self):
        src = pathlib.Path(__file__).resolve().parents[1] / "src"
        code = (
            "import importlib, pkgutil, sys, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__,"
            " 'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in"
            " ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "new = ('repro_torch.analysis.passes',"
            " 'repro_torch.analysis.contracts',"
            " 'repro_torch.analysis.__main__', 'repro_torch.roofline',"
            " 'repro_torch.tune.search', 'repro_torch.tune.artifact',"
            " 'repro_torch.train.optimizer', 'repro_torch.train.checkpoint',"
            " 'repro_torch.train.train_loop', 'repro_torch.train.pointmlp',"
            " 'repro_torch.train.grad_compress',"
            " 'repro_torch.data.pointclouds', 'repro_torch.data.lm_data',"
            " 'repro_torch.launch.steps', 'repro_torch.launch.train',"
            " 'repro_torch.models.linear_scan', 'repro_torch.models.xlstm',"
            " 'repro_torch.models.hymba', 'repro_torch.models.encdec',"
            " 'repro_torch.configs.xlstm_1_3b',"
            " 'repro_torch.configs.hymba_1_5b',"
            " 'repro_torch.configs.whisper_tiny')\n"
            "assert all(n in sys.modules for n in new), new\n"
            "print(len([n for n in sys.modules"
            " if n.startswith('repro_torch')]))\n")
        env = dict(os.environ, PYTHONPATH=str(src))
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert int(out.stdout) >= 20


# ------------------------------------------------------------- on card --

@pytest.mark.cuda
@pytest.mark.parametrize("spec_fn", [lite_spec, m2_spec])
def test_card_matches_cpu(raw_params, clouds, spec_fn):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = tiny(spec_fn, backend="cuda")
    params = from_numpy_tree(raw_params)
    out = {}
    for dev in ("cpu", "cuda"):
        pipe = build(spec, params, device=dev)
        logits, _ = pipe.infer(clouds, pipe.seed_state(SEED, B))
        out[dev] = logits.cpu()
    if spec_fn is lite_spec:
        assert torch.equal(out["cuda"], out["cpu"])
    else:
        torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-4,
                                   atol=1e-4)
