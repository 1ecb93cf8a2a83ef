"""Kernel tiles on the port (``repro_torch.kernels.tuning``, ``tune.kernels``, ``launch.profile``).

The port's counterpart of ``tests/test_kernel_tuning.py``:

* **config**: ``KernelTuning`` keeps JAX's fields, defaults and checks,
  so a tuned spec's fingerprint and label are JAX's;
* **the card's tiles**: ``resolve`` maps every field to the template or
  launch parameter it pins, a default field to the wrapper's own rule,
  and a tile a kernel lacks to a ``ValueError`` naming the tiles it has;
  the wrappers' template names and the C sources' constants agree;
* **lowering**: ``lower`` binds the pinned tiles onto each op, and
  refuses a lacking tile on any device;
* **dispatch**: a tiny Lite, M-2 and Elite (fused) under every
  ``tuning_candidates(quick=False)`` entry give ``DEFAULT_TUNING``'s
  logits bit for bit on the CPU (where the plain versions have no
  tiles), and match JAX's ``build`` at the same tiles on
  ``pallas_interpret`` (rtol 1e-4, atol 1e-4 * max|logit|, on the lanes
  whose mapping matched: ``tests/test_torch_pipeline.py``'s tolerances);
* **the sweep**: sorting, caching and skipping on ``device="cpu"``,
  ``plan_shapes`` equal to JAX's, the entry points' default device;
* **launch profiles**: ``TestLaunchProfiles``'s semantics.

``cuda``-marked cases hold every template of every kernel bitwise
against the wrapper's own pick on the card; they skip here.
"""
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from repro.api.build import build as jax_build
from repro.api.spec import elite_spec as jax_elite_spec
from repro.api.spec import lite_spec as jax_lite_spec
from repro.api.spec import m2_spec as jax_m2_spec
from repro.core import knn as jknn
from repro.core import sampling as jsampling
from repro.kernels.tuning import KernelTuning as JaxTuning
from repro.tune import kernels as JK
from repro_torch.api import plan as tplan
from repro_torch.api.build import build
from repro_torch.api.spec import elite_spec, lite_spec, m2_spec
from repro_torch.convert import from_numpy_tree
from repro_torch.core import knn as tknn
from repro_torch.core import sampling as tsampling
from repro_torch.kernels import _build, fps, fused_linear, grouped_transfer
from repro_torch.kernels import int8_matmul, knn, ops, ref
from repro_torch.kernels import tuning as T
from repro_torch.kernels.tuning import DEFAULT_TUNING, KernelTuning
from repro_torch.launch.profile import PROFILES, launch_profile
from repro_torch.models import pointmlp as TPM
from repro_torch.tune import kernels as K
from test_torch_kernels import assert_knn_match, sqdist64

TINY = dict(n_points=128, embed_dim=16, k_neighbors=8)
B = 4
SEED = 7
RTOL = 1e-4
SMALL, LARGE = K.SMALL_TILES, K.LARGE_TILES


def tiny(spec_fn, **over):
    return spec_fn(8, **TINY).replace(**over).serving()


def jax_tuning(kt):
    return JaxTuning(**dataclasses.asdict(kt))


# ------------------------------------------------------------- config --

class TestKernelTuningConfig:
    def test_defaults_reproduce_historical_tiles(self):
        t = DEFAULT_TUNING
        assert t.fused_linear == (128, 128, 128)
        assert t.int8_matmul == (128, 128, 128)
        assert t.grouped_transfer == 64
        assert t.fps == 512 and t.knn == 128
        assert t.flash_attention == (128, 128)

    def test_fields_and_defaults_are_jax(self):
        got = [(f.name, f.default) for f in dataclasses.fields(KernelTuning)]
        want = [(f.name, f.default) for f in dataclasses.fields(JaxTuning)]
        assert got == want

    def test_hashable_and_replace(self):
        a = KernelTuning()
        b = a.replace(knn=64)
        assert hash(a) == hash(KernelTuning()) and a != b
        assert b.knn == 64 and b.fused_linear == a.fused_linear

    def test_lists_coerced_to_tuples(self):
        t = KernelTuning(fused_linear=[32, 32, 32])
        assert t.fused_linear == (32, 32, 32)
        hash(t)

    @pytest.mark.parametrize("bad", [
        dict(fused_linear=(64, 64)),
        dict(int8_matmul=(64, 64, 0)),
        dict(knn=-1),
        dict(fps=True),
        dict(flash_attention=(64, 64, 64)),
    ])
    def test_invalid_tiles_rejected(self, bad):
        with pytest.raises(ValueError, match="KernelTuning"):
            KernelTuning(**bad)

    @pytest.mark.parametrize("kt", [SMALL, LARGE])
    def test_tuned_spec_fingerprint_and_label_are_jax(self, kt):
        t = tiny(lite_spec, kernel_tuning=kt)
        j = tiny(jax_lite_spec, kernel_tuning=jax_tuning(kt))
        assert tplan.spec_fingerprint(t) == jplan_fingerprint(j)
        assert tplan.spec_label(t) == jplan_label(j)
        assert tplan.spec_fingerprint(t) != tplan.spec_fingerprint(
            tiny(lite_spec))
        with pytest.raises(ValueError, match="kernel_tuning"):
            tiny(lite_spec, kernel_tuning=(64, 64, 64))


def jplan_fingerprint(spec):
    from repro.api import plan as jplan
    return jplan.spec_fingerprint(spec)


def jplan_label(spec):
    from repro.api import plan as jplan
    return jplan.spec_label(spec)


# ---------------------------------------------------- the card's tiles --

class TestResolve:
    @pytest.mark.parametrize("tile,want", [
        ((128, 16, 128), (128, False)), ((128, 16, 64), (64, False)),
        ((256, 16, 32), (32, False)), ((256, 16, 16), (16, False)),
        ((32, 32, 32), (32, True)), ((64, 32, 16), (16, True))])
    def test_fused_linear_templates(self, tile, want):
        kt = DEFAULT_TUNING.replace(fused_linear=tile)
        assert T.resolve("fused_linear", kt) == want
        t = fused_linear.template(4096, 64, 64, tile=tile)
        assert (t.bn, t.small, t.vec) == (*want, True)
        assert T.template_tile("fused_linear", *want) == tile

    @pytest.mark.parametrize("tile,bn", [
        ((128, 64, 128), 128), ((256, 64, 64), 64), ((256, 64, 32), 32),
        ((256, 64, 16), 16)])
    def test_int8_matmul_templates(self, tile, bn):
        kt = DEFAULT_TUNING.replace(int8_matmul=tile)
        assert T.resolve("int8_matmul", kt) == bn
        t = int8_matmul.template(64, 64, tile=tile)
        assert (t.bn, t.vec) == (bn, True)
        # vec stays the alignment rule: K % 16 != 0 takes the scalar route,
        # half the rows a block
        assert not int8_matmul.template(3, 64, tile=tile).vec
        assert T.template_tile("int8_matmul", bn, vec=False)[0] == \
            tile[0] // 2

    @pytest.mark.parametrize("rows,c_out,bn", [
        (128, 32, 64), (128, 64, 64), (128, 512, 128), (256, 16, 16),
        (256, 32, 32), (256, 512, 32)])
    def test_grouped_transfer_row_tiles(self, rows, c_out, bn):
        kt = DEFAULT_TUNING.replace(grouped_transfer=rows)
        assert T.resolve("grouped_transfer", kt) == rows
        t = grouped_transfer.template(4096, 32, c_out, tile=rows)
        assert (t.bn, t.small) == (bn, False)
        assert T.template_tile("grouped_transfer", bn)[0] == rows

    @pytest.mark.parametrize("tile", T.FPS_TILES)
    def test_fps_register_tiles(self, tile):
        kt = DEFAULT_TUNING.replace(fps=tile)
        want = None if tile == DEFAULT_TUNING.fps else tile // 8
        assert T.resolve("fps", kt) == want
        assert T.card_tile("fps", tile) == tile // 8
        assert fps.template(1024, tile) == (
            f"tile{tile}{'_tail' if tile < 1024 else ''}")

    @pytest.mark.parametrize("tile", [8, 16, 24, 32, 64, 256, 1024])
    def test_knn_query_tiles(self, tile):
        assert T.card_tile("knn", tile) == tile // 8
        assert T.card_tile("knn", tile, (1024, 32)) == tile // 8
        assert knn.template(32, 512, 1024, 16, tile) == f"select_q{tile}"

    @pytest.mark.parametrize("route,tile", [("ffma", (64, 64)),
                                            ("wgmma", (128, 128))])
    def test_flash_route_tiles(self, route, tile):
        assert T.card_tile("flash_attention", tile, route=route) == tile
        other = [t for r, t in T.FLASH_TILES.items() if r != route][0]
        with pytest.raises(ValueError, match=f"it has {route}"):
            T.card_tile("flash_attention", other, route=route)

    def test_default_fields_mean_the_wrapper_rule(self):
        for kernel in T.KERNELS:
            assert T.resolve(kernel, DEFAULT_TUNING) is None
            assert T.pinned(kernel, None) is None
        T.check(DEFAULT_TUNING)
        T.check(SMALL)
        T.check(LARGE)

    @pytest.mark.parametrize("kernel,tile,names", [
        ("fused_linear", (64, 64, 64), r"\(128, 16, 128\).*\(64, 32, 16\)"),
        ("int8_matmul", (64, 64, 64), r"\(128, 64, 128\).*\(256, 64, 16\)"),
        ("grouped_transfer", 32, "rows a block 128 .* and 256"),
        ("fps", 300, r"register tiles \(256, 512"),
        ("knn", 12, "multiples of 8"),
        ("flash_attention", (64, 128), r"ffma \(64, 64\), wgmma"),
    ])
    def test_lacking_tile_raises_with_the_tiles(self, kernel, tile, names):
        kt = DEFAULT_TUNING.replace(**{kernel: tile})
        with pytest.raises(ValueError, match=f"{kernel}: the card has no "
                                             f"tile .*{names}"):
            T.resolve(kernel, kt)
        with pytest.raises(ValueError, match="the card has no tile"):
            T.check(kt)

    def test_knn_tile_refused_where_the_rounds_kernel_runs(self):
        for shape in ((2000, 16), (512, 33)):
            with pytest.raises(ValueError, match="rounds kernel"):
                T.card_tile("knn", 32, shape)
        assert knn.template(1, 8, 2000, 16) == "rounds"

    def test_unknown_kernel(self):
        with pytest.raises(KeyError, match="grouped_transfer"):
            T.card_tile("conv3d", 8)


class TestWrapperMirrors:
    """The Python mirrors of the C sources' auto rules and constants."""

    def const(self, name, text):
        return int(re.search(rf"constexpr \w+ {name} = (\d+);",
                             text).group(1))

    def test_knn_auto_rule_constants(self):
        text = (_build.CSRC / "knn.cu").read_text()
        assert self.const("WARPS", text) == T.KNN_WARPS
        assert self.const("TARGET_BLOCKS", text) == knn._TARGET_BLOCKS
        # Lite's stage 1 (B32 S256) and Elite's (B32 S512)
        assert knn.queries_per_warp(32, 256) == 1
        assert knn.queries_per_warp(32, 512) == 2
        assert knn.template(32, 512, 1024, 16) == "select_q16"

    def test_fps_auto_rule(self):
        text = (_build.CSRC / "fps.cu").read_text()
        assert self.const("PT", text) == T.FPS_POINTS_PER_THREAD
        assert [fps.template(n) for n in (1, 256, 257, 1024, 8192, 9000)] \
            == ["tile256", "tile256", "tile512", "tile1024", "tile8192",
                "tile8192_tail"]

    @pytest.mark.parametrize("name,extra", [("knn", "qpw"),
                                            ("fps", "threads")])
    def test_launch_takes_the_tile_before_the_stream(self, name, extra):
        text = (_build.CSRC / f"{name}.cu").read_text()
        params = re.search(rf'extern "C" int {name}_launch\(([^)]*)\)',
                           text).group(1).split(",")
        assert params[-2].split()[-1] == extra
        assert _build.SIGNATURES[name][1][-2] is _build.I

    def test_fused_linear_template_switch_matches_the_table(self):
        """Every (BN, small) of FUSED_LINEAR_TILES has a case in the C
        switch, by the wrapper's template code."""
        text = (_build.CSRC / "fused_linear.cu").read_text()
        cases = {int(c): (int(bn), s == "true") for c, bn, s, _ in
                 re.findall(r"case (\d+): return launch<(\d+), (true|false),"
                            r" (true|false)>", text)}
        for tile, (bn, small) in T.FUSED_LINEAR_TILES.items():
            code = _build.GemmTemplate(bn, True, small).code
            assert cases[code] == (bn, small), tile


class TestCpuWrappers:
    """On CPU tensors a tile is checked, then unused."""

    def test_ops_twins_are_the_plain_versions(self):
        rng = np.random.default_rng(0)
        pts = torch.from_numpy(rng.standard_normal((2, 64, 3))
                               .astype(np.float32))
        smp = pts[:, :16].contiguous()
        want = ref.knn_ref(smp, pts, 5)
        assert torch.equal(ops.knn_batched(smp, pts, 5, tile=32), want)
        assert torch.equal(ops.knn(smp[0], pts[0], 5), want[0])
        assert torch.equal(ops.fps(pts, 8, tile=256), ref.fps_ref(pts, 8))
        assert torch.equal(ops.fps(pts[1], 8), ref.fps_ref(pts, 8)[1])

    def test_lacking_tiles_raise_on_cpu_tensors(self):
        x = torch.zeros(4, 8)
        w = torch.zeros(8, 4)
        with pytest.raises(ValueError, match="fused_linear: the card"):
            ops.fused_linear(x, w, torch.zeros(4), "relu", tile=(1, 2, 3))
        with pytest.raises(ValueError, match="int8_matmul: the card"):
            ops.int8_matmul(x, w.to(torch.int8), torch.ones(4),
                            tile=(128, 128, 128))
        with pytest.raises(ValueError, match="knn: the card"):
            ops.knn_batched(x.reshape(1, 4, 8)[..., :3].contiguous(),
                            x.reshape(1, 4, 8)[..., :3].contiguous(), 2,
                            tile=5)
        with pytest.raises(ValueError, match="fps: the card"):
            ops.fps(torch.zeros(1, 8, 3), 2, tile=100)

    def test_flash_tiles_follow_the_route(self):
        q = torch.randn(1, 2, 8, 64)
        want = ref.attention_ref(q, q, q)
        # f32 takes the ffma route, whose tile (64, 64) may be pinned
        assert torch.equal(ops.flash_attention(q, q, q, tq=64, tk=64), want)
        with pytest.raises(ValueError, match="it has wgmma"):
            qb = q.to(torch.bfloat16)
            ops.flash_attention(qb, qb, qb, tq=64, tk=64)


# ----------------------------------------------------------- lowering --

class TestLowering:
    CUSTOM = KernelTuning(fused_linear=(32, 32, 32),
                          int8_matmul=(256, 64, 32), grouped_transfer=256,
                          fps=256, knn=32)

    def lowered(self, spec):
        return tplan.lower(spec, spec.to_model_config())

    def test_fp32_tiles_bound_onto_cuda_cbr_ops(self):
        plan = self.lowered(tiny(m2_spec, backend="cuda",
                                 kernel_tuning=self.CUSTOM))
        for op in plan.cbr_ops():
            assert op.fn.keywords["tile"] == (32, 32, 32)
        assert "tiles: fused_linear (32, 32, 32)" in plan.describe()

    def test_int8_tiles_bound_onto_quant(self):
        plan = self.lowered(tiny(lite_spec, backend="cuda",
                                 kernel_tuning=self.CUSTOM))
        quants = [op.quant for op in plan.cbr_ops()]
        assert quants and all(q.backend == "int8_cuda" for q in quants)
        assert all(q.tiles == (256, 64, 32) for q in quants)
        head = plan.ops[-1]
        assert head.fc3_quant.tiles == (256, 64, 32)

    def test_fused_op_and_mapping_tiles(self):
        plan = self.lowered(tiny(elite_spec, backend="cuda",
                                 fused_group="grouped_transfer",
                                 kernel_tuning=self.CUSTOM))
        fused = [op for op in plan.ops
                 if isinstance(op, tplan.FusedGroupTransferOp)]
        assert len(fused) == 4
        assert all(op.fn.keywords == {"tile_s": 256, "knn_tile": 32}
                   for op in fused)
        samples = [op for op in plan.ops if isinstance(op, tplan.SampleOp)]
        assert [op.tile for op in samples] == [256] * 4

    def test_group_seg_and_sampler_tiles(self):
        plan = self.lowered(tiny(m2_spec, head="seg",
                                 kernel_tuning=self.CUSTOM))
        groups = [op for op in plan.ops if isinstance(op, tplan.GroupOp)]
        assert [op.tile for op in groups] == [32] * 4
        assert plan.ops[-1].knn_tile == 32
        # URS launches no FPS: its SampleOps carry no tile
        assert all(op.tile is None for op in plan.ops
                   if isinstance(op, tplan.SampleOp))
        # ref CBR ops take no tile
        assert all(not hasattr(op.fn, "keywords") for op in plan.cbr_ops())

    def test_default_tuning_binds_nothing(self):
        plan = self.lowered(tiny(elite_spec, backend="cuda",
                                 fused_group="grouped_transfer"))
        assert all(not hasattr(op.fn, "keywords") for op in plan.cbr_ops())
        assert all(getattr(op, "tile", None) is None for op in plan.ops)
        assert "tiles:" not in plan.describe()

    @pytest.mark.parametrize("field,tile", [
        ("fused_linear", (64, 64, 64)), ("int8_matmul", (32, 64, 96)),
        ("grouped_transfer", 32), ("fps", 100), ("knn", 12),
        ("flash_attention", (32, 32))])
    def test_lacking_tile_refused_at_lower(self, field, tile):
        """JAX's TestTuningThreading tiles, which the card lacks: refused
        at lower time on any device (the spec names no device)."""
        spec = tiny(m2_spec, kernel_tuning=DEFAULT_TUNING.replace(
            **{field: tile}))
        with pytest.raises(ValueError, match=f"{field}: the card has no "
                                             f"tile"):
            self.lowered(spec)


# ----------------------------------------------------------- dispatch --

def perturbed(params, rng):
    if isinstance(params, dict):
        if "bn" in params:
            c = params["bn"]["gamma"].shape[0]
            params["bn"] = {
                "gamma": rng.uniform(0.7, 1.3, c).astype(np.float32),
                "beta": (0.1 * rng.standard_normal(c)).astype(np.float32),
                "mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
        for v in params.values():
            perturbed(v, rng)
    elif isinstance(params, list):
        for v in params:
            perturbed(v, rng)
    return params


def as_numpy(tree):
    if isinstance(tree, dict):
        return {k: as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_numpy(v) for v in tree]
    return tree.numpy()


def raw_params(spec_fn, **over):
    """A raw (BN-carrying) parameter tree as numpy, BN perturbed: the
    port's ``pointmlp_init`` (the same tree layout as JAX's, which takes
    seconds to compile), handed to both packages."""
    cfg = tiny(spec_fn, **over).to_model_config()
    params = as_numpy(TPM.pointmlp_init(cfg, torch.Generator().manual_seed(0)))
    return perturbed(params, np.random.default_rng(1))


@pytest.fixture(scope="module")
def clouds():
    return np.random.default_rng(2).standard_normal(
        (B, TINY["n_points"], 3)).astype(np.float32)


def clean_lanes(pts, sampler):
    """The lanes whose mapping chains (URS or FPS, then kNN a stage)
    matched between the packages exactly (near-tie swaps reported)."""
    k = TINY["k_neighbors"]
    j_state = jsampling.seed_streams(SEED, pts.shape[0])
    t_state = tsampling.seed_streams(SEED, pts.shape[0])
    j_cur, t_cur = jnp.asarray(pts), torch.from_numpy(pts)
    ok = np.ones(pts.shape[0], bool)
    for n_samp in tiny(m2_spec).to_model_config().stage_samples:
        if sampler == "fps":
            j_idx = np.asarray(jsampling.fps_batched(j_cur, n_samp))
            t_idx = tsampling.fps(t_cur, n_samp)
        else:
            j_state, j1 = jsampling.urs_indices(j_state, j_cur.shape[1],
                                                n_samp)
            t_state, t1 = tsampling.urs_indices(t_state, t_cur.shape[1],
                                                n_samp)
            j_idx = np.broadcast_to(np.asarray(j1), (pts.shape[0], n_samp))
            t_idx = t1[None].expand(pts.shape[0], -1)
        np.testing.assert_array_equal(t_idx.numpy(), j_idx)
        j_new = jsampling.gather_points(j_cur, jnp.asarray(j_idx))
        t_new = tsampling.gather_points(t_cur, t_idx)
        j_nbr = np.asarray(jknn.knn_batched(j_new, j_cur, k))
        t_nbr = tknn.knn_batched(t_new, t_cur, k).numpy()
        assert_knn_match(t_nbr, j_nbr,
                         sqdist64(t_new.numpy(), t_cur.numpy()))
        ok &= (t_nbr == j_nbr).all(axis=(1, 2))
        j_cur, t_cur = j_new, t_new
    assert ok.sum() >= pts.shape[0] - 1, "near-tie swaps in most lanes"
    return ok


#: name -> (port spec fn, JAX spec fn, overrides)
SPECS = {"lite": (lite_spec, jax_lite_spec, {}),
         "m2": (m2_spec, jax_m2_spec, {}),
         "elite": (elite_spec, jax_elite_spec,
                   dict(fused_group="grouped_transfer"))}


@pytest.fixture(scope="module")
def jax_runs(clouds):
    """Each spec through JAX's ``build`` on ``pallas_interpret`` at the
    card's small tiles (JAX takes them: its Pallas grids pad to any tile),
    once: (logits, the parameters the port runs, its lanes)."""
    out = {}
    m2_raw = raw_params(m2_spec)
    for name, (t_fn, j_fn, over) in SPECS.items():
        raw = m2_raw if name != "elite" else raw_params(t_fn, **over)
        spec = tiny(j_fn, backend="pallas_interpret",
                    kernel_tuning=jax_tuning(SMALL), **over)
        pipe = jax_build(spec, jax.tree_util.tree_map(jnp.asarray, raw),
                         jit=False)
        logits, _ = pipe.infer(jnp.asarray(clouds),
                               jsampling.seed_streams(SEED, B))
        # Lite's int8 export is JAX's, so the int8 weights are identical
        params = (jax.tree_util.tree_map(np.asarray, pipe.params)
                  if name == "lite" else raw)
        out[name] = (np.asarray(logits), params,
                     clean_lanes(clouds, spec.sampler))
    return out


def run_port(name, params, clouds, kt):
    t_fn, _, over = SPECS[name]
    spec = tiny(t_fn, backend="cuda", kernel_tuning=kt, **over)
    pipe = build(spec, from_numpy_tree(params), device="cpu")
    logits, _ = pipe.infer(torch.from_numpy(clouds),
                           pipe.seed_state(SEED, B))
    return logits.numpy()


@pytest.mark.parametrize("name", sorted(SPECS))
def test_every_candidate_is_default_bitwise_on_cpu(jax_runs, clouds, name):
    _, params, _ = jax_runs[name]
    want = run_port(name, params, clouds, DEFAULT_TUNING)
    assert np.isfinite(want).all()
    for kt in K.tuning_candidates(quick=False)[1:]:
        np.testing.assert_array_equal(run_port(name, params, clouds, kt),
                                      want)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_tiles_match_jax_at_the_same_tiles(jax_runs, clouds, name):
    want, params, lanes = jax_runs[name]
    got = run_port(name, params, clouds, SMALL)
    np.testing.assert_allclose(got[lanes], want[lanes], rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


# ---------------------------------------------------------- the sweep --

class TestMicroAutotuner:
    @pytest.fixture(autouse=True)
    def _fresh_cache(self):
        K.clear_cache()
        yield
        K.clear_cache()

    def test_sweep_sorts_and_caches(self):
        table = K.sweep("knn", (40, 70, 5), quick=True, iters=1,
                        device="cpu", batch=2)
        assert [t for t, _ in sorted(table, key=lambda r: str(r[0]))] == \
            sorted(K.TILE_GRIDS["knn"]["quick"], key=str)
        times = [ms for _, ms in table]
        assert times == sorted(times) and all(ms > 0 for ms in times)
        assert K.sweep("knn", (40, 70, 5), quick=True, device="cpu",
                       batch=2) is table
        # another batch is another launch shape: a sweep of its own
        assert K.sweep("knn", (40, 70, 5), quick=True, iters=1,
                       device="cpu", batch=3) is not table

    def test_grids_start_with_the_default_and_name_card_tiles(self):
        for kernel, grids in K.TILE_GRIDS.items():
            for grid in grids.values():
                assert grid[0] == getattr(DEFAULT_TUNING, kernel)
                assert len(set(grid)) == len(grid)
                for tile in grid[1:]:
                    T.card_tile(kernel, tile)
            assert len(grids["quick"]) == 2

    def test_failed_tiles_skip_and_empty_sweep_raises(self):
        with pytest.raises(ValueError, match="every tile failed"):
            K.sweep("fused_linear", (32, 32, 32), grid=((64, 64, 64),),
                    iters=1, device="cpu")
        table = K.sweep("fused_linear", (32, 32, 32),
                        grid=((64, 64, 64), (32, 32, 32)), iters=1,
                        device="cpu")
        assert [t for t, _ in table] == [(32, 32, 32)]

    def test_knn_tile_skipped_past_the_select_kernel(self):
        table = K.sweep("knn", (8, 1100, 4), iters=1, device="cpu",
                        grid=(DEFAULT_TUNING.knn, 32))
        assert [t for t, _ in table] == [DEFAULT_TUNING.knn]

    def test_unknown_kernel_raises_with_names(self):
        with pytest.raises(KeyError, match="grouped_transfer"):
            K.sweep("conv3d", (8, 8), iters=1, device="cpu")

    @pytest.mark.parametrize("spec_fn,j_fn", [(lite_spec, jax_lite_spec),
                                              (elite_spec, jax_elite_spec)])
    def test_plan_shapes_are_jax(self, spec_fn, j_fn):
        assert K.plan_shapes(spec_fn(40)) == JK.plan_shapes(j_fn(40))
        assert K.plan_shapes(tiny(spec_fn)) == JK.plan_shapes(tiny(j_fn))

    def test_plan_tuning_returns_swept_tiles(self):
        kt = K.plan_tuning(tiny(elite_spec), quick=True, iters=1,
                           device="cpu", batch=2)
        assert isinstance(kt, KernelTuning)
        assert kt.fused_linear in K.TILE_GRIDS["fused_linear"]["quick"]
        assert kt.knn in K.TILE_GRIDS["knn"]["quick"]
        assert kt.flash_attention == DEFAULT_TUNING.flash_attention
        T.check(kt)

    def test_tuning_candidates_distinct_and_every_kernel_takes_them(self):
        quick = K.tuning_candidates(quick=True)
        full = K.tuning_candidates(quick=False)
        assert quick[0] == DEFAULT_TUNING and full[:2] == quick
        assert len(set(quick)) == len(quick) >= 2
        assert len(set(full)) > len(set(quick))
        for kt in full:
            T.check(kt)
            T.resolve("knn", kt, (TINY["n_points"], TINY["k_neighbors"]))

    def test_template_names_and_outputs_on_cpu(self):
        for kernel, shape in (("fused_linear", (64, 32, 16)),
                              ("int8_matmul", (64, 32, 16)),
                              ("grouped_transfer", (64, 16, 8, 8)),
                              ("fps", (128, 32)), ("knn", (32, 128, 8))):
            args = K.make_inputs(kernel, shape, batch=2, device="cpu")
            want = K.plain(kernel, args)
            for tile in K.TILE_GRIDS[kernel]["full"]:
                assert torch.equal(K.run(kernel, args, tile), want)
                assert K.template_name(kernel, args, tile)

    def test_entry_points_default_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is valid")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            K.sweep("knn", (8, 16, 2), iters=1)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            K.plan_tuning(tiny(lite_spec), quick=True, iters=1)
        assert launch_profile().name == "cuda"


# ---------------------------------------------------- launch profiles --

class TestLaunchProfiles:
    def test_explicit_env_wins(self):
        prof = PROFILES["cuda"]
        out = prof.launch_env(base={"CUDA_MODULE_LOADING": "EAGER"})
        assert "CUDA_MODULE_LOADING" not in out
        assert out["PYTORCH_CUDA_ALLOC_CONF"] == "expandable_segments:True"
        fresh = prof.launch_env(base={})
        assert fresh["CUDA_MODULE_LOADING"] == "LAZY"

    def test_apply_is_idempotent_and_undoable(self, monkeypatch):
        prof = PROFILES["cpu-ci"]
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
        first = prof.apply()
        try:
            assert first == {"CUDA_VISIBLE_DEVICES": ""}
            assert prof.apply() == {}
        finally:
            for k in first:
                os.environ.pop(k, None)

    def test_shell_prefix_renders_recipe(self):
        prefix = PROFILES["cuda"].shell_prefix()
        assert "CUDA_MODULE_LOADING=LAZY" in prefix
        assert "PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True" in prefix
        assert "XLA_FLAGS" not in prefix

    def test_resolution_and_unknown_key(self):
        assert launch_profile().name == "cuda"
        assert launch_profile("cpu-ci").name == "cpu-ci"
        with pytest.raises(KeyError, match="cpu-ci"):
            launch_profile("fpga")

    def test_imports_no_torch(self):
        import subprocess
        import sys
        src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
        code = ("import sys; sys.path.insert(0, %r); "
                "import repro_torch.launch.profile; "
                "print('torch' in sys.modules)" % src)
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, check=True)
        assert out.stdout.strip() == "False"


# ------------------------------------------------------------- on card --

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,shape", [
    ("fused_linear", (512, 512, 512)), ("fused_linear", (1, 512, 40)),
    ("fused_linear", (4096, 3, 32)), ("int8_matmul", (512, 512, 512)),
    ("int8_matmul", (4096, 3, 32)), ("grouped_transfer", (512, 256, 16, 32)),
    ("grouped_transfer", (128, 64, 16, 256)), ("fps", (1024, 512)),
    ("fps", (9000, 16)), ("knn", (512, 1024, 16)), ("knn", (32, 64, 1)),
    ("flash_attention", (8, 200, 64))])
def test_every_template_is_the_default_bitwise(cuda_device, kernel, shape):
    """Every template of the kernel's full grid gives the wrapper's own
    pick's bits (a template the route lacks is refused)."""
    for dtype in (("bfloat16", "float32") if kernel == "flash_attention"
                  else ("float32",)):
        args = K.make_inputs(kernel, shape, batch=4, dtype=dtype,
                             device=cuda_device)
        want = K.run(kernel, args, K.TILE_GRIDS[kernel]["full"][0])
        for tile in K.TILE_GRIDS[kernel]["full"][1:]:
            try:
                got = K.run(kernel, args, tile)
            except ValueError:
                assert kernel == "flash_attention" and dtype == "bfloat16"
                continue
            torch.cuda.synchronize()
            assert torch.equal(got, want), (kernel, shape, tile)
