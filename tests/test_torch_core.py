"""Parity of the port's core numerics (``repro_torch.core``) with ``repro.core``.

Inputs come from ``np.random.default_rng(seed)`` and go through the JAX
function and its port counterpart.  Tolerances, by function:

* LFSR words, ``seed_streams``, URS indices, quantization and the int8
  export: exact (integer arithmetic, or one IEEE division and a
  half-to-even rounding on both sides).
* ``fuse_conv_bn``: rtol 1e-6 (``rsqrt`` may differ by an ulp between
  XLA and PyTorch).
* ``normalize_group``: rtol 1e-5 (the sigma mean is a float reduction
  summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from repro.core import fusion as jfusion
from repro.core import knn as jknn
from repro.core import quant as jquant
from repro.core import sampling as jsampling
from repro_torch.core import fusion, knn, quant, sampling


def t(a):
    return torch.from_numpy(np.array(a))


def n(x):
    return np.asarray(x)


# ------------------------------------------------------------ sampling --

class TestSampling:
    @pytest.mark.parametrize("seed", [0, 7, 12345, 2 ** 31 + 5])
    def test_seed_streams_exact(self, seed):
        want = n(jsampling.seed_streams(seed, 37)).astype(np.int64)
        np.testing.assert_array_equal(sampling.seed_streams(seed, 37).numpy(),
                                      want)

    @pytest.mark.parametrize("nbits", [8, 16, 24, 32])
    def test_lfsr_sequence_exact(self, nbits):
        rng = np.random.default_rng(nbits)
        state = rng.integers(1, 2 ** nbits, size=9).astype(np.uint32)
        js, jv = jsampling.lfsr_sequence(jnp.asarray(state), 50, nbits)
        ps, pv = sampling.lfsr_sequence(t(state.astype(np.int64)), 50, nbits)
        np.testing.assert_array_equal(ps.numpy(), n(js).astype(np.int64))
        np.testing.assert_array_equal(pv.numpy(), n(jv).astype(np.int64))

    def test_lfsr_step_exact(self):
        state = np.random.default_rng(1).integers(
            1, 2 ** 32, size=64).astype(np.uint32)
        want = n(jsampling.lfsr_step(jnp.asarray(state), 32))
        got = sampling.lfsr_step(t(state.astype(np.int64)), 32)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))

    @pytest.mark.parametrize("n_points,n_samples", [(512, 256), (100, 37)])
    def test_urs_indices_exact(self, n_points, n_samples):
        state = jsampling.seed_streams(3, 8)
        js, jidx = jsampling.urs_indices(state, n_points, n_samples)
        ps, pidx = sampling.urs_indices(sampling.seed_streams(3, 8),
                                        n_points, n_samples)
        np.testing.assert_array_equal(pidx.numpy(), n(jidx))
        # every stream advanced n_samples steps, not just stream 0
        np.testing.assert_array_equal(ps.numpy(), n(js).astype(np.int64))

    def test_urs_indices_batched_exact(self):
        state = jsampling.seed_streams(11, 6)
        js, jidx = jsampling.urs_indices_batched(state, 128, 64, batch=4)
        ps, pidx = sampling.urs_indices_batched(sampling.seed_streams(11, 6),
                                                128, 64, batch=4)
        np.testing.assert_array_equal(pidx.numpy(), n(jidx))
        np.testing.assert_array_equal(ps.numpy(), n(js).astype(np.int64))

    def test_urs_batched_rejects_short_state(self):
        with pytest.raises(ValueError, match="one LFSR stream"):
            sampling.urs_indices_batched(sampling.seed_streams(0, 2), 64, 8,
                                         batch=4)

    def test_state_accepts_uint32(self):
        s32 = n(jsampling.seed_streams(5, 4))
        a = sampling.urs_indices(torch.from_numpy(s32.astype(np.int64)),
                                 64, 10)[1]
        b = sampling.urs_indices(s32, 64, 10)[1]
        np.testing.assert_array_equal(a.numpy(), b.numpy())

    def test_gather_points_exact(self):
        rng = np.random.default_rng(2)
        pts = rng.standard_normal((3, 40, 5)).astype(np.float32)
        idx = rng.integers(0, 40, size=(3, 11)).astype(np.int32)
        want = n(jsampling.gather_points(jnp.asarray(pts), jnp.asarray(idx)))
        got = sampling.gather_points(t(pts), t(idx))
        np.testing.assert_array_equal(got.numpy(), want)


# -------------------------------------------------------------- quant --

class TestQuant:
    @pytest.mark.parametrize("bits", [4, 8])
    def test_scale_and_quantize_exact(self, bits):
        x = np.random.default_rng(bits).standard_normal(
            (7, 33)).astype(np.float32) * 3
        js = jquant.compute_scale(jnp.asarray(x), bits)
        ps = quant.compute_scale(t(x), bits)
        np.testing.assert_array_equal(ps.numpy(), n(js))
        np.testing.assert_array_equal(
            quant.quantize(t(x), ps, bits).numpy(),
            n(jquant.quantize(jnp.asarray(x), js, bits)))

    def test_per_axis_scale_exact(self):
        x = np.random.default_rng(0).standard_normal(
            (4, 5, 6)).astype(np.float32)
        for axis in (0, 1, -1):
            np.testing.assert_array_equal(
                quant.compute_scale(t(x), 8, axis).numpy(),
                n(jquant.compute_scale(jnp.asarray(x), 8, axis)))

    def test_round_half_to_even(self):
        x = np.array([0.5, 1.5, 2.5, -0.5, -1.5], np.float32)
        one = np.float32(1.0)
        got = quant.quantize(t(x), torch.tensor(one), 8).numpy()
        np.testing.assert_array_equal(
            got, n(jquant.quantize(jnp.asarray(x), one, 8)))
        np.testing.assert_array_equal(got, [0, 2, 2, -0, -2])

    @pytest.mark.parametrize("per_channel", [True, False])
    def test_quantize_weight_int8_exact(self, per_channel):
        w = np.random.default_rng(4).standard_normal(
            (2, 24, 10)).astype(np.float32)
        cfg_j = jquant.QuantConfig(per_channel=per_channel)
        cfg_p = quant.QuantConfig(per_channel=per_channel)
        want = jquant.quantize_weight_int8(jnp.asarray(w), cfg_j)
        got = quant.quantize_weight_int8(t(w), cfg_p)
        assert got["q"].dtype == torch.int8
        np.testing.assert_array_equal(got["q"].numpy(), n(want["q"]))
        np.testing.assert_array_equal(got["scale"].numpy(), n(want["scale"]))

    def test_quantize_tree_exact_and_predicate(self):
        rng = np.random.default_rng(5)
        tree = {"a": {"w": rng.standard_normal((8, 4)).astype(np.float32),
                      "b": rng.standard_normal(4).astype(np.float32)},
                "l": [{"w": rng.standard_normal((4, 3)).astype(np.float32)}]}
        jt = {"a": {k: jnp.asarray(v) for k, v in tree["a"].items()},
              "l": [{"w": jnp.asarray(tree["l"][0]["w"])}]}
        pt = {"a": {k: t(v) for k, v in tree["a"].items()},
              "l": [{"w": t(tree["l"][0]["w"])}]}
        want = jquant.quantize_tree(jt, jquant.QuantConfig())
        got = quant.quantize_tree(pt, quant.QuantConfig())
        for path in (("a",), ("l", 0)):
            g, w_ = got, want
            for p in path:
                g, w_ = g[p], w_[p]
            np.testing.assert_array_equal(g["w"]["q"].numpy(), n(w_["w"]["q"]))
            np.testing.assert_array_equal(g["w"]["scale"].numpy(),
                                          n(w_["w"]["scale"]))
        np.testing.assert_array_equal(got["a"]["b"].numpy(), tree["a"]["b"])
        only_l = quant.quantize_tree(pt, quant.QuantConfig(),
                                     predicate=lambda p, x: p[0] == "l"
                                     and p[-1] == "w")
        assert isinstance(only_l["l"][0]["w"], dict)
        assert isinstance(only_l["a"]["w"], torch.Tensor)
        # an already-exported tree passes through unchanged
        again = quant.quantize_tree(got, quant.QuantConfig())
        assert again["a"]["w"]["q"] is got["a"]["w"]["q"]

    def test_is_quantizable_leaf_path(self):
        assert quant.is_quantizable_leaf_path(("head", "fc1", "w"))
        assert quant.is_quantizable_leaf_path(("x", "proj_w"))
        assert not quant.is_quantizable_leaf_path(("head", "fc1", "b"))
        assert not quant.is_quantizable_leaf_path(("w", "q"))


# ------------------------------------------------------------- fusion --

class TestFusion:
    def bn(self, rng, c):
        return {"gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "beta": rng.standard_normal(c).astype(np.float32),
                "mean": rng.standard_normal(c).astype(np.float32),
                "var": rng.uniform(0.2, 2.0, c).astype(np.float32)}

    def test_fuse_conv_bn_matches_jax(self):
        rng = np.random.default_rng(6)
        w = rng.standard_normal((16, 8)).astype(np.float32)
        b = rng.standard_normal(8).astype(np.float32)
        bn = self.bn(rng, 8)
        jw, jb = jfusion.fuse_conv_bn(jnp.asarray(w), jnp.asarray(b),
                                      {k: jnp.asarray(v) for k, v in bn.items()})
        pw, pb = fusion.fuse_conv_bn(t(w), t(b), {k: t(v) for k, v in bn.items()})
        np.testing.assert_allclose(pw.numpy(), n(jw), rtol=1e-6)
        np.testing.assert_allclose(pb.numpy(), n(jb), rtol=1e-6, atol=1e-6)

    def test_fused_layer_equals_bn_of_layer(self):
        rng = np.random.default_rng(7)
        x = t(rng.standard_normal((5, 16)).astype(np.float32))
        w = t(rng.standard_normal((16, 8)).astype(np.float32))
        b = t(rng.standard_normal(8).astype(np.float32))
        bn = {k: t(v) for k, v in self.bn(rng, 8).items()}
        fw, fb = fusion.fuse_conv_bn(w, b, bn)
        torch.testing.assert_close(x @ fw + fb,
                                   fusion.batchnorm_apply(x @ w + b, bn),
                                   rtol=1e-5, atol=1e-5)

    def test_fuse_tree_drops_bn(self):
        rng = np.random.default_rng(8)
        tree = {"l": [{"w": t(rng.standard_normal((4, 3)).astype(np.float32)),
                       "b": torch.zeros(3),
                       "bn": {k: t(v) for k, v in self.bn(rng, 3).items()}}],
                "fc3": {"w": torch.ones(3, 2), "b": torch.zeros(2)}}
        fused = fusion.fuse_tree(tree)
        assert set(fused["l"][0]) == {"w", "b"}
        assert fused["fc3"]["w"] is tree["fc3"]["w"]


# ---------------------------------------------------------------- knn --

class TestGrouping:
    @pytest.mark.parametrize("per_sample", [False, True])
    @pytest.mark.parametrize("mode", ["norm", "affine", "center"])
    def test_normalize_group(self, per_sample, mode):
        rng = np.random.default_rng(9)
        g = rng.standard_normal((3, 10, 4, 6)).astype(np.float32)
        c = rng.standard_normal((3, 10, 6)).astype(np.float32)
        aff = {"alpha": rng.standard_normal(6).astype(np.float32),
               "beta": rng.standard_normal(6).astype(np.float32)}
        want = jknn.normalize_group(jnp.asarray(g), jnp.asarray(c),
                                    {k: jnp.asarray(v) for k, v in aff.items()},
                                    mode, per_sample=per_sample)
        got = knn.normalize_group(t(g), t(c), {k: t(v) for k, v in aff.items()},
                                  mode, per_sample=per_sample)
        np.testing.assert_allclose(got.numpy(), n(want), rtol=1e-5, atol=1e-6)

    def test_per_sample_sigma_is_per_cloud(self):
        rng = np.random.default_rng(10)
        g = t(rng.standard_normal((2, 5, 4, 3)).astype(np.float32))
        c = t(rng.standard_normal((2, 5, 3)).astype(np.float32))
        both = knn.normalize_group(g, c, None, "norm", per_sample=True)
        alone = knn.normalize_group(g[:1], c[:1], None, "norm", per_sample=True)
        assert torch.equal(both[:1], alone)

    def test_pairwise_sqdist_close_to_jax(self):
        rng = np.random.default_rng(11)
        s = rng.standard_normal((20, 3)).astype(np.float32)
        p = rng.standard_normal((50, 3)).astype(np.float32)
        np.testing.assert_allclose(
            knn.pairwise_sqdist(t(s), t(p)).numpy(),
            n(jknn.pairwise_sqdist(jnp.asarray(s), jnp.asarray(p))),
            rtol=1e-5, atol=1e-5)

    def test_gather_neighbors_exact(self):
        rng = np.random.default_rng(12)
        f = rng.standard_normal((2, 30, 7)).astype(np.float32)
        idx = rng.integers(0, 30, size=(2, 9, 4)).astype(np.int32)
        np.testing.assert_array_equal(
            knn.gather_neighbors(t(f), t(idx).long()).numpy(),
            n(jknn.gather_neighbors(jnp.asarray(f), jnp.asarray(idx))))

    def test_group_points_matches_jax(self):
        rng = np.random.default_rng(13)
        xyz = rng.standard_normal((2, 64, 3)).astype(np.float32)
        feats = rng.standard_normal((2, 64, 8)).astype(np.float32)
        idx = rng.integers(0, 64, size=(2, 16)).astype(np.int32)
        jx, jc, jg = jknn.group_points(jnp.asarray(xyz), jnp.asarray(feats),
                                       jnp.asarray(idx), 8, None, "norm",
                                       per_sample_norm=True)
        px, pc, pg = knn.group_points(t(xyz), t(feats), t(idx), 8, None,
                                      "norm", per_sample_norm=True)
        np.testing.assert_array_equal(px.numpy(), n(jx))
        np.testing.assert_array_equal(pc.numpy(), n(jc))
        np.testing.assert_allclose(pg.numpy(), n(jg), rtol=1e-5, atol=1e-6)

    def test_ball_radius_waits(self):
        """The ball query no longer waits for its ROADMAP item:
        ``neighbor_index(radius=)`` gives ``repro``'s indices (this input
        has no distance near the radius or a tie)."""
        rng = np.random.default_rng(9)
        pts = rng.uniform(-1, 1, (2, 40, 3)).astype(np.float32)
        smp = pts[:, :10]
        got = knn.neighbor_index(t(smp), t(pts), 6, radius=0.5)
        want = jknn.neighbor_index(jnp.asarray(smp), jnp.asarray(pts), 6,
                                   radius=0.5)
        np.testing.assert_array_equal(got.numpy(), n(want))
        assert (got[..., 1:] == got[..., :1]).any()
