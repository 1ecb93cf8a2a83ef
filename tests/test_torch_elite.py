"""Parity of the port's PointMLP-Elite path (FPS, fused group->transfer) with ``repro``.

The same inputs, drawn with ``np.random.default_rng``, go through the JAX
package and the port on the CPU, where every port wrapper runs its
kernel's plain version.  The JAX side runs its Pallas kernels in
interpret mode, as its own tests run them.  Tolerances:

* FPS indices: exact, against both ``sampling.fps_batched`` and
  ``fps_pallas``.  Both sides form ``(dx*dx + dy*dy) + dz*dz`` and take
  the first maximum, so no near-tie allowance is needed.
* ``grouped_transfer``: rtol = atol = 1e-5.  The product sums 2C float32
  terms in another order, and the port sums sigma's mean in float64
  where the JAX kernel sums it in float32 (about an ulp apart).
* Elite end to end, at the tiny size of ``test_torch_pipeline`` (128
  points, embed 16, k=8, B=4): FPS indices exact; kNN indices exact
  apart from reported near-tie swaps; logits within rtol 1e-4 and atol
  1e-4 * max|logit|, on the lanes whose mapping matched (fp32 sums in
  another order, compounded over 15 layers).

Tests marked ``cuda`` hold the FPS and ``grouped_transfer`` kernels
against the same plain versions on the card, and Elite served on the
card against the CPU; they skip where no GPU is present.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from repro.api.build import build as jax_build
from repro.api.spec import elite_spec as jax_elite_spec
from repro.core import knn as jknn
from repro.core import sampling as jsampling
from repro.kernels import grouped_transfer as jgt
from repro.kernels.fps import fps_pallas
from repro.models import pointmlp as JPM
from repro_torch.api import registry
from repro_torch.api.build import build
from repro_torch.api.spec import elite_spec
from repro_torch.convert import from_numpy_tree
from repro_torch.core import knn as tknn
from repro_torch.core import sampling as tsampling
from repro_torch.kernels import fps as fps_mod
from repro_torch.kernels import grouped_transfer as gt_mod
from repro_torch.kernels import ref
from repro_torch.serve.batching import pad_to_batch
from repro_torch.serve.pointcloud import PointCloudEngine
from test_torch_kernels import assert_knn_match, sqdist64

TINY = dict(n_points=128, embed_dim=16, k_neighbors=8)
B = 4
SEED = 7
RTOL = 1e-4
GT_TOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def tiny(serving=True, **over):
    spec = jax_elite_spec if over.pop("jax", False) else elite_spec
    s = spec(8, **TINY).replace(**over)
    return s.serving() if serving else s


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# ---------------------------------------------------------------- fps --

def jax_fps_pallas(pts, s):
    return np.stack([np.asarray(fps_pallas(jnp.asarray(p), s,
                                           interpret=True)) for p in pts])


class TestFps:
    @pytest.mark.parametrize("n,s", [(128, 32), (50, 17)])
    def test_plain_matches_jax_exactly(self, n, s):
        pts = np.random.default_rng(n + s).standard_normal(
            (3, n, 3)).astype(np.float32)
        got = tsampling.fps(t(pts), s)
        assert got.dtype == torch.int64 and got.shape == (3, s)
        want = np.asarray(jsampling.fps_batched(jnp.asarray(pts), s))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), jax_fps_pallas(pts, s))

    def test_duplicate_points_tie_to_the_lowest_index(self):
        rng = np.random.default_rng(3)
        base = rng.standard_normal((6, 3)).astype(np.float32)
        pts = base[rng.integers(0, 6, size=(2, 40))]       # 40 of 6 points
        got = tsampling.fps(t(pts), 12).numpy()
        want = np.asarray(jsampling.fps_batched(jnp.asarray(pts), 12))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jax_fps_pallas(pts, 12))
        for lane in range(2):
            # the first time each distinct point is picked, it is by its
            # lowest index among its copies
            for j in got[lane][:6]:
                first = np.flatnonzero((pts[lane] == pts[lane][j]).all(1))[0]
                assert j == first

    def test_all_zero_cloud_gives_all_zeros(self):
        pts = np.zeros((2, 64, 3), np.float32)
        pts[1] = np.random.default_rng(4).standard_normal((64, 3))
        got = tsampling.fps(t(pts), 16).numpy()
        assert (got[0] == 0).all()
        np.testing.assert_array_equal(
            got, np.asarray(jsampling.fps_batched(jnp.asarray(pts), 16)))

    def test_wrapper_checks(self):
        with pytest.raises(ValueError, match=r"\[B, N, C\]"):
            fps_mod.fps(torch.zeros(8, 3), 2)
        with pytest.raises(ValueError, match="n_samples >= 1"):
            fps_mod.fps(torch.zeros(1, 8, 3), 0)
        with pytest.raises(ValueError, match="CUDA"):
            fps_mod.fps_cuda(torch.zeros(1, 8, 3), 2)

    def test_sampler_passes_the_lfsr_state_through(self):
        fn = registry.SAMPLERS.get("fps")
        state = tsampling.seed_streams(0, 2)
        pts = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (2, 32, 3)).astype(np.float32))
        for shared in (True, False):
            idx, out = fn(pts, 8, state, shared)
            assert out is state and idx.shape == (2, 8)
        assert fn.advances_state is False

    @pytest.mark.cuda
    @pytest.mark.parametrize("b,n,s", [(4, 1024, 512), (4, 128, 64),
                                       (3, 50, 17), (2, 9000, 8)])
    def test_kernel_matches_plain_on_card(self, cuda_device, b, n, s):
        # N = 9000 is past the register tile: the tail's minima go to a
        # scratch buffer (no N limit since the kernel's redesign)
        pts = torch.from_numpy(np.random.default_rng(n).standard_normal(
            (b, n, 3)).astype(np.float32))
        pts[0] = 0                                    # a padded lane
        pts[1, n // 2:] = pts[1, :n - n // 2]         # duplicates
        before = fps_mod.fps_cuda.launches
        got = fps_mod.fps(pts.to(cuda_device), s)
        torch.cuda.synchronize()
        assert fps_mod.fps_cuda.launches == before + 1
        assert torch.equal(got.cpu(), ref.fps_ref(pts, s))
        assert (got[0] == 0).all()


# --------------------------------------------------- grouped_transfer --

def gt_inputs(seed, b=2, n=64, s=40, k=8, c=16, c_out=32):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        feats=rng.standard_normal((b, n, c)).astype(f32),
        nidx=rng.integers(0, n, size=(b, s, k)).astype(np.int64),
        centers=rng.standard_normal((b, s, c)).astype(f32),
        alpha=rng.uniform(0.7, 1.3, c).astype(f32),
        beta=(0.1 * rng.standard_normal(c)).astype(f32),
        w=(rng.standard_normal((2 * c, c_out)) / np.sqrt(2 * c)).astype(f32),
        b=(0.1 * rng.standard_normal(c_out)).astype(f32))


def jax_gt(x, sigma, **kw):
    """grouped_transfer_pallas in interpret mode, one cloud at a time."""
    out = []
    for i in range(x["feats"].shape[0]):
        sig = None if sigma is None else jnp.full((1, 1), sigma[i])
        out.append(np.asarray(jgt.grouped_transfer_pallas(
            jnp.asarray(x["feats"][i]), jnp.asarray(x["nidx"][i], jnp.int32),
            jnp.asarray(x["centers"][i]), sig, jnp.asarray(x["alpha"][None]),
            jnp.asarray(x["beta"][None]), jnp.asarray(x["w"]),
            jnp.asarray(x["b"][None]), k=x["nidx"].shape[2],
            interpret=True, **kw)))
    return np.stack(out)


def port_gt(x, sigma, **kw):
    return gt_mod.grouped_transfer(
        t(x["feats"]), t(x["nidx"]), t(x["centers"]),
        None if sigma is None else t(sigma), t(x["alpha"]), t(x["beta"]),
        t(x["w"]), t(x["b"]), **kw).numpy()


class TestGroupedTransfer:
    @pytest.mark.parametrize("affine", [True, False])
    def test_stats_variant_matches_jax(self, affine):
        """S=40 is not a multiple of the JAX kernel's tile_s=64, so its
        pad mask is exercised."""
        x = gt_inputs(20)
        want = jax_gt(x, None, affine=affine)
        got = port_gt(x, None, affine=affine)
        assert got.shape == (2, 40, 8, 32)
        np.testing.assert_allclose(got, want, rtol=GT_TOL, atol=GT_TOL)

    @pytest.mark.parametrize("normalize", [True, False])
    def test_given_sigma_variant_matches_jax(self, normalize):
        x = gt_inputs(21)
        sigma = np.array([0.8, 1.7], np.float32)
        want = jax_gt(x, sigma, normalize=normalize, affine=normalize)
        got = port_gt(x, sigma if normalize else None, normalize=normalize,
                      affine=normalize)
        np.testing.assert_allclose(got, want, rtol=GT_TOL, atol=GT_TOL)

    def test_stats_sigma_is_the_unfused_sigma(self):
        """The stats variant equals the given-sigma one fed
        ``group_sigma``'s per-cloud sigma, bit for bit."""
        x = gt_inputs(22)
        off = (tknn.gather_neighbors(t(x["feats"]), t(x["nidx"]))
               - t(x["centers"])[:, :, None, :])
        sigma = tknn.group_sigma(off, per_sample=True).reshape(-1)
        np.testing.assert_array_equal(port_gt(x, None),
                                      port_gt(x, sigma.numpy()))

    @pytest.mark.parametrize("per_sample", [True, False])
    def test_fused_group_transfer_matches_jax(self, per_sample):
        rng = np.random.default_rng(23)
        xyz = rng.standard_normal((2, 64, 3)).astype(np.float32)
        x = gt_inputs(24, n=64, s=24, k=8, c=16, c_out=32)
        idx = rng.choice(64, size=(2, 24)).astype(np.int64)
        aff = {"alpha": x["alpha"], "beta": x["beta"]}
        p = {"w": x["w"], "b": x["b"]}
        jx, jc, jo = jgt.fused_group_transfer(
            jnp.asarray(xyz), jnp.asarray(x["feats"]),
            jnp.asarray(idx, jnp.int32), 8,
            {k: jnp.asarray(v) for k, v in aff.items()}, "affine",
            per_sample, {k: jnp.asarray(v) for k, v in p.items()},
            interpret=True)
        px, pc, po = registry.FUSED_OPS.get("grouped_transfer")(
            {k: t(v) for k, v in p.items()}, t(xyz), t(x["feats"]), t(idx),
            8, {k: t(v) for k, v in aff.items()}, "affine", per_sample)
        np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
        np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=GT_TOL,
                                   atol=GT_TOL)

    def test_fused_equals_unfused_group_then_transfer(self):
        """On the same inputs the fused wrapper gives the unfused
        grouper + transfer layer's result."""
        from repro_torch.kernels import ops
        rng = np.random.default_rng(25)
        xyz = t(rng.standard_normal((2, 64, 3)).astype(np.float32))
        x = gt_inputs(26, n=64, s=16)
        idx = t(rng.choice(64, size=(2, 16)).astype(np.int64))
        aff = {"alpha": t(x["alpha"]), "beta": t(x["beta"])}
        p = {"w": t(x["w"]), "b": t(x["b"])}
        for mode in ("affine", "norm", "center"):
            for per_sample in (True, False):
                _, _, fused = gt_mod.fused_group_transfer(
                    xyz, t(x["feats"]), idx, 8, aff, mode, per_sample, p)
                _, _, grouped = tknn.group_points(
                    xyz, t(x["feats"]), idx, 8, aff, mode, per_sample)
                unfused = ops.fused_linear(grouped, p["w"], p["b"], "relu")
                torch.testing.assert_close(fused, unfused, rtol=1e-6,
                                           atol=1e-6)

    def test_rejects_int8_or_unfused_transfer_layer(self):
        x = torch.zeros(1, 16, 3)
        f = torch.zeros(1, 16, 4)
        idx = torch.zeros(1, 4, dtype=torch.int64)
        for p in ({"w": {"q": torch.zeros(8, 8, dtype=torch.int8)}},
                  {"w": torch.zeros(8, 8), "b": torch.zeros(8),
                   "bn": {}}):
            with pytest.raises(ValueError, match="fused fp32 transfer"):
                gt_mod.fused_group_transfer(x, f, idx, 4, None, "norm",
                                            True, p)

    def test_wrapper_checks(self):
        x = gt_inputs(27)
        with pytest.raises(ValueError, match="2C"):
            gt_mod.grouped_transfer(
                t(x["feats"]), t(x["nidx"]), t(x["centers"]), None,
                t(x["alpha"]), t(x["beta"]), t(x["w"][:4]), t(x["b"]))
        with pytest.raises(ValueError, match="CUDA"):
            gt_mod.grouped_transfer_stats_cuda(
                t(x["feats"]), t(x["nidx"]), t(x["centers"]), t(x["alpha"]),
                t(x["beta"]), t(x["w"]), t(x["b"]))
        with pytest.raises(ValueError, match="needs sigma"):
            gt_mod.grouped_transfer_cuda(
                t(x["feats"]), t(x["nidx"]), t(x["centers"]), None,
                t(x["alpha"]), t(x["beta"]), t(x["w"]), t(x["b"]))

    @pytest.mark.cuda
    @pytest.mark.parametrize("n,s,c,c_out", [(1024, 512, 32, 64),
                                             (512, 256, 64, 128),
                                             (256, 128, 128, 256),
                                             (128, 64, 256, 512),
                                             (64, 40, 16, 40),
                                             (64, 40, 20, 40),
                                             (64, 40, 10, 30)])
    def test_kernels_match_plain_on_card(self, cuda_device, n, s, c, c_out):
        """Both variants (and "center") within GT_TOL of the plain version
        at Elite's four stage widths, a 16-k step straddling C (C = 20)
        and the scalar route (C % 4 != 0); a cloud alone equals its lane
        in the dispatch."""
        x = gt_inputs(28, b=3, n=n, s=s, k=16, c=c, c_out=c_out)
        cpu = {k: t(v) for k, v in x.items()}
        dev = {k: v.to(cuda_device) for k, v in cpu.items()}
        sigma = torch.tensor([0.5, 1.0, 2.0])
        for fn, sig, kw in (
                (gt_mod.grouped_transfer_stats_cuda, None, {}),
                (gt_mod.grouped_transfer_cuda, sigma, {}),
                (gt_mod.grouped_transfer_cuda, sigma,
                 dict(normalize=False, affine=False))):
            before = fn.launches
            got = gt_mod.grouped_transfer(
                dev["feats"], dev["nidx"], dev["centers"],
                None if sig is None else sig.to(cuda_device), dev["alpha"],
                dev["beta"], dev["w"], dev["b"], **kw)
            torch.cuda.synchronize()
            assert fn.launches == before + 1
            want = ref.grouped_transfer_ref(
                cpu["feats"], cpu["nidx"], cpu["centers"], sig, cpu["alpha"],
                cpu["beta"], cpu["w"], cpu["b"], **kw)
            torch.testing.assert_close(got.cpu(), want, rtol=GT_TOL,
                                       atol=GT_TOL)
            alone = gt_mod.grouped_transfer(
                dev["feats"][1:2], dev["nidx"][1:2], dev["centers"][1:2],
                None if sig is None else sig[1:2].to(cuda_device),
                dev["alpha"], dev["beta"], dev["w"], dev["b"], **kw)
            assert torch.equal(alone[0], got[1])


# ------------------------------------------------------ end to end ----

def perturb(node, rng):
    """Draw non-trivial BN statistics and affine alpha/beta, so neither
    the BN fold nor the affine is an identity."""
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
            perturb(v, rng)
    elif isinstance(node, list):
        for v in node:
            perturb(v, rng)


@pytest.fixture(scope="module")
def elite_params():
    cfg = tiny(jax=True).to_model_config()
    init = jax.jit(JPM.pointmlp_init, static_argnums=1)
    params = jax.tree_util.tree_map(np.asarray,
                                    init(jax.random.PRNGKey(0), cfg))
    perturb(params, np.random.default_rng(1))
    assert "affine" in params["stages"][0]
    return params


@pytest.fixture(scope="module")
def clouds():
    return np.random.default_rng(2).standard_normal(
        (B, TINY["n_points"], 3)).astype(np.float32)


@pytest.fixture(scope="module")
def lanes(clouds):
    """Compare the mapping chains (FPS, then kNN per stage) of both
    packages; return the lanes whose kNN indices matched exactly."""
    k = TINY["k_neighbors"]
    j_cur, t_cur = jnp.asarray(clouds), torch.from_numpy(clouds)
    ok = np.ones(B, bool)
    for n_samp in tiny().to_model_config().stage_samples:
        j_idx = np.asarray(jsampling.fps_batched(j_cur, n_samp))
        t_idx = tsampling.fps(t_cur, n_samp)
        np.testing.assert_array_equal(t_idx.numpy(), j_idx)
        j_new = jsampling.gather_points(j_cur, jnp.asarray(j_idx))
        t_new = tsampling.gather_points(t_cur, t_idx)
        j_nbr = np.asarray(jknn.knn_batched(j_new, j_cur, k))
        t_nbr = tknn.knn_batched(t_new, t_cur, k).numpy()
        assert_knn_match(t_nbr, j_nbr,
                         sqdist64(t_new.numpy(), t_cur.numpy()))
        ok &= (t_nbr == j_nbr).all(axis=(1, 2))
        j_cur, t_cur = j_new, t_new
    assert ok.sum() >= B - 1, "near-tie swaps in most lanes"
    return ok


def run_jax(spec, params, pts):
    pipe = jax_build(spec, jax.tree_util.tree_map(jnp.asarray, params),
                     jit=False)
    logits, _ = pipe.infer(jnp.asarray(pts),
                           jsampling.seed_streams(SEED, pts.shape[0]))
    return np.asarray(logits)


def run_port(spec, params, pts, device="cpu"):
    pipe = build(spec, from_numpy_tree(params), device=device)
    state = pipe.seed_state(SEED, pts.shape[0])
    logits, out_state = pipe.infer(torch.from_numpy(pts), state)
    assert torch.equal(out_state, state)          # FPS passes it through
    return logits.cpu().numpy()


@pytest.fixture(scope="module")
def port_unfused(elite_params, clouds):
    return run_port(tiny(), elite_params, clouds)


class TestEliteParity:
    @pytest.mark.parametrize("serving,fused", [(True, False), (True, True),
                                               (False, True)])
    def test_matches_jax(self, elite_params, clouds, lanes, serving, fused):
        over = dict(fused_group="grouped_transfer") if fused else {}
        want = run_jax(tiny(serving, jax=True, **over), elite_params,
                       clouds)
        got = run_port(tiny(serving, **over), elite_params, clouds)
        assert got.shape == (B, 8) and np.isfinite(got).all()
        np.testing.assert_allclose(got[lanes], want[lanes], rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())

    def test_fused_serving_equals_unfused(self, elite_params, clouds,
                                         port_unfused):
        got = run_port(tiny(fused_group="grouped_transfer"), elite_params,
                       clouds)
        np.testing.assert_allclose(got, port_unfused, rtol=1e-6,
                                   atol=1e-6 * np.abs(port_unfused).max())

    def test_pad_lanes_do_not_leak(self, elite_params, clouds):
        pipe = build(tiny(fused_group="grouped_transfer"),
                     from_numpy_tree(elite_params), device="cpu")
        full = torch.from_numpy(clouds)
        alone, _ = pad_to_batch(full[2:3], B)
        a, _ = pipe.infer(full, pipe.seed_state(SEED, B))
        b, _ = pipe.infer(alone, pipe.seed_state(SEED, B))
        torch.testing.assert_close(a[2], b[0], rtol=1e-5, atol=1e-5)

    def test_engine_serves_fps(self, elite_params, port_unfused, clouds):
        spec = tiny(fused_group="grouped_transfer", backend="cuda")
        eng = PointCloudEngine(from_numpy_tree(elite_params), spec,
                               max_batch=3, seed=SEED, device="cpu")
        before = eng.lfsr_state
        got = eng.classify(list(clouds))
        assert got.shape == (B, 8) and eng.stats.batches == 2
        assert torch.equal(eng.lfsr_state, before)
        np.testing.assert_allclose(got.numpy(), port_unfused, rtol=1e-5,
                                   atol=1e-5 * np.abs(port_unfused).max())
        text = eng.describe()
        assert "fps (farthest point" in text
        assert "fused with the transfer layer: grouped_transfer" in text
        assert text.count("[group->transfer fused: grouped_transfer]") == 4

    def test_plan_swaps_group_and_transfer(self, elite_params):
        from repro_torch.api import plan as tplan
        pipe = build(tiny(fused_group="grouped_transfer"),
                     from_numpy_tree(elite_params), device="cpu")
        ops = pipe.plan.ops
        fused = [op for op in ops if isinstance(op, tplan.FusedGroupTransferOp)]
        assert [op.stage for op in fused] == [0, 1, 2, 3]
        assert not any(isinstance(op, tplan.GroupOp) for op in ops)
        assert all(op.cbr.path == ("stages", op.stage, "transfer")
                   for op in fused)
        assert len(pipe.plan.cbr_ops()) == 27
        assert pipe.plan.fused_group == "grouped_transfer"


@pytest.mark.cuda
@pytest.mark.parametrize("serving,fused", [(True, False), (True, True),
                                           (False, True)])
def test_card_matches_cpu(cuda_device, elite_params, clouds, serving, fused):
    over = dict(fused_group="grouped_transfer") if fused else {}
    spec = tiny(serving, backend="cuda", **over)
    cpu = run_port(spec, elite_params, clouds)
    card = run_port(spec, elite_params, clouds, device=cuda_device)
    np.testing.assert_allclose(card, cpu, rtol=RTOL,
                               atol=RTOL * np.abs(cpu).max())
