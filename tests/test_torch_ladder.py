"""The compression ladder, the ``ball`` grouper and the seg head of the port, against ``repro``.

The port's ``core/compress.py``, ``compression_ladder_specs``, ball query
and seg head go through the same inputs as the JAX package's: clouds from
``np.random.default_rng``, parameters drawn by ``repro.models.pointmlp.
pointmlp_init`` with BN statistics perturbed from a numpy seed and carried
across by ``repro_torch.convert.from_numpy_tree``.  Pipelines run at the
rung's own point count with narrow widths (embed 16, k 8, 8 classes) on
the CPU, where every kernel wrapper runs its plain version.  Tolerances:

* ladders, sweeps and specs: field for field, exact.
* ``compress``: report counts and bytes exact; fused fp32 weights rtol
  1e-6 (an ulp of ``rsqrt``), int8 codes within one step on at most 0.1%
  of the weights (that ulp can tip a code at a tie).
* ``infer``: rtol 1e-4, atol 1e-4 * max|logit|, on the lanes whose
  mapping matched, as ``test_torch_pipeline`` (float32 sums in another
  order over the walk; for W8A8 the same int8 products and a sigma an
  ulp apart).
  In W8A8 both packages' activations ``v = x / scale`` are recorded
  layer by layer (JAX's through ``jax.debug.callback``).  A lane whose
  int8 codes differ is left out and reported, and only where, at the
  first layer that differs, each differing code is one step apart and
  the two ``v`` lie within ``TIE_EPS * qmax`` of each other (activations
  that agree to ``TIE_EPS`` of the lane's absmax, on either side of a
  rounding boundary).  The packages' sigmas differ by an ulp (JAX sums
  the mean in float32, the port in float64), so such a code is decided
  by rounding; at 16 activation bits the grid is fine enough that
  float32 noise reaches it.  One code a step off moves its lane's logits
  by far more than the bound.
* ball query: indices exact, except two kinds of boundary swap, which
  are counted and reported: a kNN near tie (``assert_knn_match``'s
  ``1e-6`` relative), and a pick whose distance lies within
  ``BALL_MARGIN * (|s|^2 + |p|^2)`` of radius^2 (the two packages round
  the expansion ``|s|^2 - 2 s.p + |p|^2`` differently, by about that
  much).  With ``radius=inf`` the port's ball query equals its kNN
  bitwise.
* the int8 activation cast: identical codes (saturating, as XLA's
  ``astype(jnp.int8)``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from repro.api.build import build as jax_build
from repro.api.spec import PipelineSpec as JaxSpec
from repro.api.spec import compression_ladder_specs as jax_ladder_specs
from repro.api.spec import lite_spec as jax_lite_spec
from repro.api.spec import m2_spec as jax_m2_spec
from repro.core import compress as jcompress
from repro.core import knn as jknn
from repro.core import quant as jquant
from repro.core import sampling as jsampling
from repro.models import pointmlp as JPM
from repro_torch.api import registry
from repro_torch.api.build import build
from repro_torch.api.spec import (PipelineSpec, compression_ladder_specs,
                                  lite_spec, m2_spec)
from repro_torch.convert import from_numpy_tree
from repro_torch.core import compress
from repro_torch.core import knn as tknn
from repro_torch.core import sampling as tsampling
from repro_torch.kernels import ops
from repro_torch.models import pointmlp as TPM
from test_torch_kernels import assert_knn_match, sqdist64

NARROW = dict(embed_dim=16, k_neighbors=8, n_classes=8)
B = 3
SEED = 7
RTOL = 1e-4
BALL_MARGIN = 1e-6
TIE_EPS = 2.0 ** -16
SWEEP = [c.name for c in jcompress.precision_sweep()]
LADDER = [c.name for c in jcompress.compression_ladder()]


def narrow(spec, **over):
    return spec.replace(**NARROW, **over).serving()


def perturbed(params, seed):
    """Non-trivial BN statistics (and affine alpha/beta), from a seed."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            if "bn" in node:
                c = node["bn"]["gamma"].shape[0]
                node["bn"] = {
                    "gamma": rng.uniform(0.7, 1.3, c).astype(np.float32),
                    "beta": (0.1 * rng.standard_normal(c)).astype(np.float32),
                    "mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
            if "affine" in node:
                c = node["affine"]["alpha"].shape[0]
                node["affine"] = {
                    "alpha": rng.uniform(0.7, 1.3, c).astype(np.float32),
                    "beta": (0.1 * rng.standard_normal(c)).astype(np.float32)}
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)
    walk(params)
    return params


def jax_params(cfg, seed=1):
    """A raw (BN-carrying) JAX tree for ``cfg`` as numpy, BN perturbed."""
    tree = JPM.pointmlp_init(jax.random.PRNGKey(0), cfg)
    return perturbed(jax.tree_util.tree_map(np.asarray, tree), seed)


@pytest.fixture(scope="module")
def m2_params():
    """Raw params of the narrow M-2 topology (the M-1 .. M-4 rungs and
    every sweep rung share it: the point count draws no weight)."""
    return jax_params(JPM.pointmlp_m2_config(8).replace(
        embed_dim=16, k_neighbors=8))


@pytest.fixture(scope="module")
def seg_params():
    return jax_params(JPM.pointmlp_m2_config(8).replace(
        embed_dim=16, k_neighbors=8, head="seg"), seed=3)


def clouds(n_points, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (B, n_points, 3)).astype(np.float32)


def run_jax(spec, params_np, pts):
    pipe = jax_build(spec, jax.tree_util.tree_map(jnp.asarray, params_np),
                     jit=False)
    logits, _ = pipe.infer(jnp.asarray(pts),
                           jsampling.seed_streams(SEED, pts.shape[0]))
    frozen = jax.tree_util.tree_map(np.asarray, pipe.params)
    return np.asarray(logits), frozen


def run_port(spec, params_np, pts):
    pipe = build(spec, from_numpy_tree(params_np), device="cpu")
    logits, _ = pipe.infer(torch.from_numpy(pts),
                           pipe.seed_state(SEED, pts.shape[0]))
    return logits.numpy()


def codes(v, a_bits):
    """The saturated int8 codes of activations ``v = x / scale``."""
    lo, hi = jquant.qrange(a_bits)
    return np.clip(np.round(v), max(lo, -128), min(hi, 127))


def w8a8_pair(monkeypatch, j_spec, t_spec, params_np, pts):
    """Both packages through the int8 kernels' path (JAX's Pallas kernel in
    interpret mode, the port's plain version), with each one's activations
    ``x / scale`` recorded per layer and lane.  Returns (JAX logits, port
    logits, lanes whose activation codes all agree); a lane that differs
    must do so at rounding ties only (see the module docstring)."""
    from repro.kernels import ops as jops
    j_log, t_log = [], []
    j_quantize, t_quantize = jops.quantize, ops.quantize_activations

    def j_record(x, scale, bits):
        jax.debug.callback(lambda v: j_log.append(np.asarray(v)),
                           x / scale, ordered=True)
        return j_quantize(x, scale, bits)

    def t_record(x, a_bits, lanes=1):
        x_q, a_scale = t_quantize(x, a_bits, lanes)
        t_log.append((x.reshape(lanes, -1) / a_scale[:, None]).numpy())
        return x_q, a_scale

    monkeypatch.setattr(jops, "quantize", j_record)
    want, frozen = run_jax(j_spec, params_np, pts)
    monkeypatch.setattr(ops, "quantize_activations", t_record)
    got = run_port(t_spec, frozen, pts)
    monkeypatch.undo()
    b, layers = pts.shape[0], len(t_log)
    assert len(j_log) == b * layers       # lax.map: lane by lane
    agree = np.ones(b, bool)
    for lane in range(b):
        for layer in range(layers):
            tv = t_log[layer][lane]
            jv = j_log[lane * layers + layer].reshape(-1)
            tc, jc = codes(tv, t_spec.a_bits), codes(jv, t_spec.a_bits)
            differ = tc != jc
            if differ.any():
                qmax = 2 ** (t_spec.a_bits - 1) - 1
                gap = np.abs(tv - jv)[differ]
                assert (np.abs(tc - jc)[differ] == 1).all() and (
                    gap <= TIE_EPS * qmax).all(), (
                    f"lane {lane} layer {layer}: int8 codes differ beyond "
                    f"a rounding boundary (largest gap {gap.max()})")
                print(f"lane {lane} left out: {int(differ.sum())} "
                      f"activation codes at a rounding boundary in layer "
                      f"{layer}")
                agree[lane] = False
                break
    return want, got, agree


def clean_lanes(spec, pts, seg=False):
    """Compare both packages' URS and per-stage kNN indices (and the seg
    head's 1-NN upsample); return the lanes whose indices all matched."""
    k = spec.k_neighbors
    j_state = jsampling.seed_streams(SEED, pts.shape[0])
    t_state = tsampling.seed_streams(SEED, pts.shape[0])
    j_cur, t_cur = jnp.asarray(pts), torch.from_numpy(pts)
    ok = np.ones(pts.shape[0], bool)

    def compare(t_nbr, j_nbr, t_q, t_p):
        nonlocal ok
        j_nbr = np.asarray(j_nbr)
        assert_knn_match(t_nbr, j_nbr, sqdist64(t_q.numpy(), t_p.numpy()))
        ok &= (t_nbr == j_nbr).reshape(pts.shape[0], -1).all(axis=1)

    for n_samp in spec.to_model_config().stage_samples:
        j_state, j_idx = jsampling.urs_indices(j_state, j_cur.shape[1],
                                               n_samp)
        t_state, t_idx = tsampling.urs_indices(t_state, t_cur.shape[1],
                                               n_samp)
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
        j_new = j_cur[:, np.asarray(j_idx)]
        t_new = tsampling.gather_points(
            t_cur, t_idx[None].expand(pts.shape[0], -1))
        compare(tknn.knn_batched(t_new, t_cur, k).numpy(),
                jknn.knn_batched(j_new, j_cur, k), t_new, t_cur)
        j_cur, t_cur = j_new, t_new
    if seg:
        t_all = torch.from_numpy(pts)
        compare(tknn.knn_batched(t_all, t_cur, 1).numpy(),
                jknn.knn_batched(jnp.asarray(pts), j_cur, 1), t_all, t_cur)
    assert ok.sum() >= pts.shape[0] - 1, "near-tie swaps in most lanes"
    return ok


def assert_logits_close(got, want, lanes):
    np.testing.assert_allclose(got[lanes], want[lanes], rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def same_config(t_cfg, j_cfg):
    """Every PointMLPConfig field equal; the quant configs on the fields
    both packages have (the port has no fake-quant ``backend``, and no
    tiles or interpret flag)."""
    names = [f.name for f in dataclasses.fields(j_cfg)]
    assert [f.name for f in dataclasses.fields(t_cfg)] == names
    for name in names:
        if name == "quant":
            for q in ("w_bits", "a_bits", "per_channel", "symmetric",
                      "enabled"):
                assert getattr(t_cfg.quant, q) == getattr(j_cfg.quant, q), q
        else:
            assert getattr(t_cfg, name) == getattr(j_cfg, name), name
    assert t_cfg.stage_samples == j_cfg.stage_samples
    assert t_cfg.stage_dims == j_cfg.stage_dims


# ------------------------------------------------------------- ladder --

class TestLadder:
    @pytest.mark.parametrize("rung", range(len(LADDER)))
    def test_compression_ladder_field_for_field(self, rung):
        same_config(compress.compression_ladder(10)[rung],
                    jcompress.compression_ladder(10)[rung])

    @pytest.mark.parametrize("rung", range(len(SWEEP)))
    def test_precision_sweep_field_for_field(self, rung):
        same_config(compress.precision_sweep(10)[rung],
                    jcompress.precision_sweep(10)[rung])

    @pytest.mark.parametrize("rung", range(len(LADDER)))
    def test_ladder_specs_field_for_field(self, rung):
        got = compression_ladder_specs(10)[rung]
        want = jax_ladder_specs(10)[rung]
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.validate() is got

    @pytest.mark.parametrize("rung", range(len(SWEEP)))
    def test_from_model_config_round_trips_the_sweep(self, rung):
        t_cfg = compress.precision_sweep()[rung]
        spec = PipelineSpec.from_model_config(t_cfg)
        want = JaxSpec.from_model_config(jcompress.precision_sweep()[rung])
        assert dataclasses.asdict(spec) == dataclasses.asdict(want)
        same_config(spec.to_model_config(), t_cfg)
        assert PipelineSpec.from_model_config(
            t_cfg, precision="fp32").precision == "fp32"


def _compress_case(name, m2_params):
    """(port config, JAX config, raw numpy params) of a ladder or sweep
    rung named ``name``, at the narrow widths."""
    rungs = {**{c.name: (c, j) for c, j in zip(
        compress.compression_ladder(8), jcompress.compression_ladder(8))},
        **{c.name: (c, j) for c, j in zip(
            compress.precision_sweep(8), jcompress.precision_sweep(8))}}
    t_cfg, j_cfg = rungs[name]
    t_cfg = t_cfg.replace(embed_dim=16, k_neighbors=8)
    j_cfg = j_cfg.replace(embed_dim=16, k_neighbors=8)
    params = (jax_params(j_cfg, seed=4) if j_cfg.affine_mode == "affine"
              else m2_params)
    return t_cfg, j_cfg, params


class TestCompress:
    @pytest.mark.parametrize("name", sorted(set(LADDER) | set(SWEEP)))
    def test_report_and_deploy_tree_match_jax(self, m2_params, name):
        t_cfg, j_cfg, params = _compress_case(name, m2_params)
        j_tree, j_dcfg, j_rep = jcompress.compress(
            jax.tree_util.tree_map(jnp.asarray, params), j_cfg)
        t_tree, t_dcfg, t_rep = compress.compress(from_numpy_tree(params),
                                                  t_cfg)
        assert dataclasses.asdict(t_rep) == dataclasses.asdict(j_rep)
        assert t_rep.bn_blocks_fused == TPM.count_conv_layers(t_cfg) + 2
        same_config(t_dcfg, j_dcfg)
        assert not t_dcfg.use_bn
        assert t_dcfg.quant.backend == ("int8_ref" if t_cfg.quant.enabled
                                        else t_cfg.quant.backend)
        j_leaves = jax.tree_util.tree_flatten_with_path(
            jax.tree_util.tree_map(np.asarray, j_tree))[0]
        t_leaves = jax.tree_util.tree_flatten_with_path(
            t_tree, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]
        assert [p for p, _ in t_leaves] == [p for p, _ in j_leaves]
        off = total = 0
        for (_, a), (_, b) in zip(j_leaves, t_leaves):
            b = b.numpy()
            assert b.dtype == a.dtype and b.shape == a.shape
            if a.dtype == np.int8:
                diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
                assert diff.max() <= 1
                off, total = off + int((diff > 0).sum()), total + a.size
            else:
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
        assert off <= 1e-3 * total
        assert (total > 0) == (t_cfg.quant.enabled
                               and t_cfg.quant.w_bits <= 8)

    def test_cuda_backend_key_and_a_frozen_tree(self, m2_params):
        t_cfg, _, params = _compress_case("pointmlp-lite", m2_params)
        tree, dcfg, rep = compress.compress(from_numpy_tree(params), t_cfg,
                                            backend="int8_cuda")
        assert dcfg.quant.backend == "int8_cuda"
        assert rep.size_ratio_vs_f32 > 3.5
        # a frozen tree has no BN left and keeps its int8 codes
        again, _, rep2 = compress.compress(tree, dcfg, backend="int8_cuda")
        assert rep2.bn_blocks_fused == 0
        assert torch.equal(again["embed"]["w"]["q"], tree["embed"]["w"]["q"])


# -------------------------------------------------------- ladder rungs --

class TestRungs:
    @pytest.mark.parametrize("rung", ["M-1", "M-3", "M-4"])
    def test_rung_infer_matches_jax(self, m2_params, rung):
        """The port's serving path (``cuda`` backend: ``fused_linear``'s
        plain version on the CPU) against JAX's ``ref`` walk."""
        i = LADDER.index(rung)
        j_spec = narrow(jax_ladder_specs(8)[i])
        t_spec = narrow(compression_ladder_specs(8)[i], backend="cuda")
        pts = clouds(t_spec.n_points)
        want, _ = run_jax(j_spec, m2_params, pts)
        got = run_port(t_spec, m2_params, pts)
        assert got.shape == (B, 8) and np.isfinite(got).all()
        assert_logits_close(got, want, clean_lanes(t_spec, pts))

    @pytest.mark.parametrize("name", ["M-2-w4a4", "M-2-w6a6", "M-2-w4a8",
                                      "M-2-w8a16"])
    def test_sweep_rung_w8a8_path_matches_jax(self, monkeypatch, m2_params,
                                              name):
        """Sweep rungs through the int8 kernel's path (per-lane scales),
        against JAX's Pallas kernel in interpret mode.  At a_bits = 16 the
        activation codes saturate at +-127 on both sides."""
        i = SWEEP.index(name)
        j_spec = narrow(JaxSpec.from_model_config(
            jcompress.precision_sweep(8)[i]), n_points=128,
            backend="pallas_interpret")
        t_spec = narrow(PipelineSpec.from_model_config(
            compress.precision_sweep(8)[i]), n_points=128, backend="cuda")
        pts = clouds(128)
        want, got, agree = w8a8_pair(monkeypatch, j_spec, t_spec,
                                     m2_params, pts)
        assert np.isfinite(got).all()
        lanes = clean_lanes(t_spec, pts) & agree
        assert lanes.any()
        assert_logits_close(got, want, lanes)


# --------------------------------------------------------------- ball --

def ball_case(seed, b=2, s=48, n=192):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    smp = pts[:, rng.choice(n, s, replace=False)]
    return smp, pts


class TestBall:
    @pytest.mark.parametrize("radius", [0.15, 0.3, 0.5, 1.0])
    @pytest.mark.parametrize("k", [1, 8, 16])
    def test_ball_query_matches_jax(self, radius, k):
        smp, pts = ball_case(int(radius * 100) + k)
        got = tknn.ball_query_batched(torch.from_numpy(smp),
                                      torch.from_numpy(pts), k,
                                      radius).numpy()
        want = np.asarray(jknn.ball_query_batched(
            jnp.asarray(smp), jnp.asarray(pts), k, radius))
        d64 = sqdist64(smp, pts)
        scale = ((smp.astype(np.float64) ** 2).sum(-1)[..., :, None]
                 + (pts.astype(np.float64) ** 2).sum(-1)[..., None, :])
        r2 = float(np.float32(radius) * np.float32(radius))
        t_knn = tknn.knn_batched(torch.from_numpy(smp),
                                 torch.from_numpy(pts), k).numpy()
        j_knn = np.asarray(jknn.knn_batched(jnp.asarray(smp),
                                            jnp.asarray(pts), k))
        knn_swaps = assert_knn_match(t_knn, j_knn, d64)
        differ = got != want
        if differ.any():
            # a boundary pick: the kNN order near-tied, or one package's
            # pick at a distance within the margin of radius^2
            rows = np.nonzero(differ.any(-1))
            near_tie = (t_knn != j_knn)[rows].any(-1)
            for pick in (t_knn, j_knn):
                at = np.take_along_axis(d64, pick, -1)[rows]
                sc = np.take_along_axis(scale, pick, -1)[rows]
                near_tie |= (np.abs(at - r2) <= BALL_MARGIN * sc).any(-1)
            assert near_tie.all(), (
                f"{int((~near_tie).sum())} ball-query rows differ beyond "
                f"the stated margins")
            print(f"reported ball-query boundary swaps: {int(differ.sum())} "
                  f"of {differ.size} indices ({knn_swaps} kNN near ties)")
        fills = (got[..., 1:] == got[..., :1]).sum()
        if radius <= 0.3 and k > 1:
            assert fills > 0, "the radius filled no pick"
        # a fill is pick 0; a kept pick is the kNN pick
        np.testing.assert_array_equal(
            np.where(got == t_knn, 0, got - t_knn[..., :1]), 0)

    @pytest.mark.parametrize("k", [1, 8, 16])
    def test_infinite_radius_is_knn_bitwise(self, k):
        smp, pts = ball_case(k)
        ts, tp = torch.from_numpy(smp), torch.from_numpy(pts)
        assert torch.equal(tknn.ball_query_batched(ts, tp, k, float("inf")),
                           tknn.knn_batched(ts, tp, k))
        assert torch.equal(tknn.ball_query(ts[0], tp[0], k, float("inf")),
                           tknn.knn(ts[0], tp[0], k))

    @pytest.mark.parametrize("radius", [0.0, -0.5, float("nan")])
    def test_bad_radius_rejected(self, radius):
        with pytest.raises(ValueError, match="radius must be positive"):
            registry.make_ball_grouper(radius)
        x = torch.zeros(1, 4, 3)
        with pytest.raises(ValueError, match="radius must be positive"):
            tknn.ball_query_batched(x, x, 2, radius)

    def test_grouper_entry_and_neighbor_index(self):
        grouper = registry.GROUPERS.get("ball")
        assert grouper.radius == registry.DEFAULT_BALL_RADIUS == 0.5
        smp, pts = ball_case(0)
        ts, tp = torch.from_numpy(smp), torch.from_numpy(pts)
        np.testing.assert_array_equal(
            tknn.neighbor_index(ts, tp, 8, radius=0.5).numpy(),
            np.asarray(jknn.neighbor_index(jnp.asarray(smp),
                                           jnp.asarray(pts), 8, radius=0.5)))

    def test_ball_pipeline_matches_jax(self, m2_params):
        """M-2 with ``grouper="ball"`` end to end: indices compared stage
        by stage through ``neighbor_index(radius=0.5)``, logits at 1e-4."""
        j_spec = narrow(jax_m2_spec(8), n_points=128, grouper="ball")
        t_spec = narrow(m2_spec(8), n_points=128, grouper="ball",
                        backend="cuda")
        pts = clouds(128, seed=5)
        want, _ = run_jax(j_spec, m2_params, pts)
        got = run_port(t_spec, m2_params, pts)
        j_state = jsampling.seed_streams(SEED, B)
        t_state = tsampling.seed_streams(SEED, B)
        j_cur, t_cur = jnp.asarray(pts), torch.from_numpy(pts)
        for n_samp in t_spec.to_model_config().stage_samples:
            j_state, j_idx = jsampling.urs_indices(j_state, j_cur.shape[1],
                                                   n_samp)
            t_state, t_idx = tsampling.urs_indices(t_state, t_cur.shape[1],
                                                   n_samp)
            j_new = j_cur[:, np.asarray(j_idx)]
            t_new = tsampling.gather_points(t_cur, t_idx[None].expand(B, -1))
            np.testing.assert_array_equal(
                tknn.neighbor_index(t_new, t_cur, 8, radius=0.5).numpy(),
                np.asarray(jknn.neighbor_index(j_new, j_cur, 8,
                                               radius=0.5)))
            j_cur, t_cur = j_new, t_new
        assert_logits_close(got, want, np.ones(B, bool))


# ---------------------------------------------------------------- seg --

class TestSeg:
    def test_m2_seg_matches_jax(self, seg_params):
        j_spec = narrow(jax_m2_spec(8), n_points=128, head="seg")
        t_spec = narrow(m2_spec(8), n_points=128, head="seg",
                        backend="cuda")
        pts = clouds(128, seed=6)
        want, _ = run_jax(j_spec, seg_params, pts)
        got = run_port(t_spec, seg_params, pts)
        assert got.shape == (B, 128, 8) and np.isfinite(got).all()
        assert_logits_close(got, want, clean_lanes(t_spec, pts, seg=True))

    @pytest.mark.parametrize("j_backend,t_backend", [
        ("pallas_interpret", "cuda"), ("ref", "ref")])
    def test_lite_seg_matches_jax(self, monkeypatch, seg_params, j_backend,
                                  t_backend):
        """Lite's seg head: W8A8 per-lane (the port's int8 path against
        the Pallas kernel) and W8 dequantized, at Lite's cls bound."""
        pts = clouds(128, seed=6)
        j_spec = narrow(jax_lite_spec(8), n_points=128, head="seg",
                        backend=j_backend)
        t_spec = narrow(lite_spec(8), n_points=128, head="seg",
                        backend=t_backend)
        lanes = clean_lanes(t_spec, pts, seg=True)
        if t_backend == "cuda":
            want, got, agree = w8a8_pair(monkeypatch, j_spec, t_spec,
                                         seg_params, pts)
            lanes &= agree
        else:
            want, frozen = run_jax(j_spec, seg_params, pts)
            got = run_port(t_spec, frozen, pts)
        assert got.shape == (B, 128, 8) and np.isfinite(got).all()
        assert lanes.any()
        assert_logits_close(got, want, lanes)

    def test_seg_plan_params_and_flops(self, seg_params):
        t_spec = narrow(lite_spec(8), n_points=128, head="seg")
        j_cfg = narrow(jax_lite_spec(8), n_points=128,
                       head="seg").to_model_config()
        t_cfg = t_spec.to_model_config()
        assert TPM.pointmlp_flops_breakdown(t_cfg) == \
            JPM.pointmlp_flops_breakdown(j_cfg)
        tree = TPM.pointmlp_init(t_cfg, torch.Generator().manual_seed(0))
        assert tuple(tree["head"]["fc1"]["w"].shape) == \
            seg_params["head"]["fc1"]["w"].shape == (16 + 2 * 256, 512)
        pipe = build(t_spec, from_numpy_tree(seg_params), device="cpu")
        kinds = [type(op).__name__ for op in pipe.plan.ops]
        assert kinds[-1] == "SegHeadOp" and "HeadOp" not in kinds
        assert kinds.count("PoolOp") == 4          # no global pool op
        assert len(pipe.plan.cbr_ops()) == 27
        assert "head: seg/int8" in pipe.describe()

    def test_engine_returns_per_point_logits(self, seg_params):
        from repro_torch.serve.pointcloud import PointCloudEngine
        eng = PointCloudEngine(from_numpy_tree(seg_params),
                               narrow(m2_spec(8), n_points=128, head="seg"),
                               max_batch=2, seed=SEED, device="cpu")
        queue = clouds(128)
        logits = eng.classify(queue)
        assert logits.shape == (B, 128, 8)
        assert eng.predict(queue).shape == (B, 128)
        assert eng.classify(np.zeros((0, 128, 3))).shape == (0, 128, 8)


# --------------------------------------------------- int8 activations --

@pytest.mark.parametrize("a_bits", [4, 6, 8, 16])
def test_activation_cast_saturates_as_jax(a_bits):
    """``quantize(x, scale, a_bits).astype(jnp.int8)`` saturates in XLA;
    the port's per-lane quantize must give the same codes and scale."""
    x = np.random.default_rng(0).standard_normal((4, 64)).astype(np.float32)
    j_scale = jquant.compute_scale(jnp.asarray(x), a_bits)
    want = np.asarray(jquant.quantize(jnp.asarray(x), j_scale,
                                      a_bits).astype(jnp.int8))
    got, scale = ops.quantize_activations(torch.from_numpy(x), a_bits)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(scale.numpy(), np.asarray(j_scale)[None])
    np.testing.assert_array_equal(got.numpy(), want)
