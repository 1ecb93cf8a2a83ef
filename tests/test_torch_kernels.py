"""Parity of the port's kernel wrappers (``repro_torch.kernels``) with ``repro.kernels``.

On the CPU every wrapper runs its kernel's plain version, so these tests
hold the plain versions against the JAX package's Pallas kernels (run in
interpret mode) and their ``ref.py`` oracles.  Tolerances, by kernel:

* kNN indices: exact.  The one exception is a reported swap of two
  neighbours whose distances differ by less than ``1e-6`` relative: the
  JAX package forms the cross term with a dot product, the port sums it
  elementwise in channel order, so a near tie may order differently.
* int8 matmul: bitwise (integer accumulation, the same f32 dequantize).
* fused linear: rtol 1e-5 (a float32 sum over K in another order).

Tests marked ``cuda`` hold the CUDA kernels against the same plain
versions on the card and skip where no GPU is present.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fused_linear import fused_linear_pallas
from repro.kernels.knn import knn_pallas
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import fused_linear as fl_mod
from repro_torch.kernels import int8_matmul as i8_mod
from repro_torch.kernels import knn as knn_mod

SWAP_RTOL = 1e-6


def t(a):
    return torch.from_numpy(np.array(a))


def assert_knn_match(got, want, dist):
    """Indices equal, except swaps of near-tied neighbours, which are
    reported.  got/want [..., S, k]; dist [..., S, N] float64 distances."""
    got, want = np.asarray(got), np.asarray(want)
    d_got = np.take_along_axis(dist, got, axis=-1)
    d_want = np.take_along_axis(dist, want, axis=-1)
    differ = got != want
    scale = np.maximum(np.abs(d_want), 1e-12)
    ties = np.abs(d_got - d_want) <= SWAP_RTOL * scale
    assert np.all(ties[differ]), (
        f"{int((differ & ~ties).sum())} kNN indices differ beyond near ties")
    if differ.any():
        print(f"reported near-tie kNN swaps: {int(differ.sum())} of "
              f"{differ.size} indices")
    return int(differ.sum())


def sqdist64(s, p):
    s, p = np.asarray(s, np.float64), np.asarray(p, np.float64)
    return ((s[..., :, None, :] - p[..., None, :, :]) ** 2).sum(-1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# ---------------------------------------------------------------- knn --

class TestKnn:
    @pytest.mark.parametrize("s,n,c,k", [(32, 128, 3, 8), (17, 50, 3, 5),
                                         (8, 200, 5, 16), (1, 16, 3, 16)])
    def test_plain_matches_jax_ref_and_pallas(self, s, n, c, k):
        rng = np.random.default_rng(s * n + c)
        smp = rng.standard_normal((s, c)).astype(np.float32)
        pts = rng.standard_normal((n, c)).astype(np.float32)
        got = ref.knn_ref(t(smp), t(pts), k).numpy()
        dist = sqdist64(smp, pts)
        assert_knn_match(got, jref.knn_ref(jnp.asarray(smp),
                                           jnp.asarray(pts), k), dist)
        # pads N up to 128 and S up to the tile: padding is never picked
        assert_knn_match(got, knn_pallas(jnp.asarray(smp), jnp.asarray(pts),
                                         k, interpret=True), dist)

    def test_exact_ties_go_to_the_lowest_index(self):
        # integer grid: every distance is exact, with many equal values
        rng = np.random.default_rng(0)
        pts = rng.integers(-2, 3, size=(60, 3)).astype(np.float32)
        smp = pts[:12]
        got = ref.knn_ref(t(smp), t(pts), 10).numpy()
        want = np.asarray(knn_pallas(jnp.asarray(smp), jnp.asarray(pts), 10,
                                     interpret=True))
        np.testing.assert_array_equal(got, want)
        d = sqdist64(smp, pts)
        np.testing.assert_array_equal(
            got, np.argsort(d, axis=-1, kind="stable")[:, :10])

    def test_batched_wrapper_and_zero_lanes(self):
        rng = np.random.default_rng(3)
        pts = rng.standard_normal((3, 64, 3)).astype(np.float32)
        pts[1] = 0.0                      # a zero-padded lane
        smp = pts[:, :16]
        got = knn_mod.knn(t(smp), t(pts), 8)
        assert got.dtype == torch.int64 and got.shape == (3, 16, 8)
        for b in (0, 2):
            assert_knn_match(got[b].numpy(),
                             jref.knn_ref(jnp.asarray(smp[b]),
                                          jnp.asarray(pts[b]), 8),
                             sqdist64(smp[b], pts[b]))
        # all distances equal: the lowest indices, in order
        np.testing.assert_array_equal(got[1].numpy(),
                                      np.tile(np.arange(8), (16, 1)))

    def test_wrapper_rejects_bad_input(self):
        x = torch.zeros(2, 8, 3)
        with pytest.raises(ValueError, match="k <= N"):
            knn_mod.knn(x, x, 9)
        with pytest.raises(ValueError, match="batch and channel"):
            knn_mod.knn(x, torch.zeros(2, 8, 4), 2)
        with pytest.raises(ValueError, match="CUDA"):
            knn_mod.knn_cuda(x, x, 2)

    @pytest.mark.cuda
    @pytest.mark.parametrize("b,s,n", [(4, 256, 512), (4, 32, 64),
                                       (3, 7, 37)])
    def test_kernel_matches_plain_on_card(self, cuda_device, b, s, n):
        rng = np.random.default_rng(b * s + n)
        pts = t(rng.standard_normal((b, n, 3)).astype(np.float32))
        smp = pts[:, :s].clone()
        pts, smp = pts.to(cuda_device), smp.to(cuda_device)
        before = knn_mod.knn_cuda.launches
        got = knn_mod.knn(smp, pts, 16)
        torch.cuda.synchronize()
        assert knn_mod.knn_cuda.launches == before + 1
        assert torch.equal(got, ref.knn_ref(smp, pts, 16))


# --------------------------------------------------------------- int8 --

class TestInt8Matmul:
    @pytest.mark.parametrize("m,k,n", [(64, 3, 16), (37, 40, 24),
                                       (128, 256, 64), (5, 512, 40)])
    def test_matches_jax_interpret_bitwise(self, m, k, n):
        rng = np.random.default_rng(m + k + n)
        x = (rng.standard_normal((m, k)) * 2).astype(np.float32)
        w_q = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
        w_scale = rng.uniform(1e-3, 1e-2, size=(1, n)).astype(np.float32)
        want = jops.int8_matmul(jnp.asarray(x), jnp.asarray(w_q),
                                jnp.asarray(w_scale), interpret=True)
        got = ops.int8_matmul(t(x), t(w_q), t(w_scale))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_per_lane_scale_matches_jax_per_cloud(self):
        """lanes=L is the JAX wrapper applied to each cloud on its own."""
        rng = np.random.default_rng(1)
        x = rng.standard_normal((4, 6, 5, 24)).astype(np.float32)
        x[2] *= 50.0                      # one loud lane
        x[3] = 0.0                        # one zero-padded lane
        w_q = rng.integers(-127, 128, size=(24, 16)).astype(np.int8)
        w_scale = rng.uniform(1e-3, 1e-2, size=(1, 16)).astype(np.float32)
        got = ops.int8_matmul(t(x), t(w_q), t(w_scale), lanes=4)
        assert got.shape == (4, 6, 5, 16)
        for lane in range(4):
            want = jops.int8_matmul(jnp.asarray(x[lane:lane + 1]),
                                    jnp.asarray(w_q), jnp.asarray(w_scale),
                                    interpret=True)
            np.testing.assert_array_equal(got[lane:lane + 1].numpy(),
                                          np.asarray(want))

    def test_ref_matches_jax_ref(self):
        rng = np.random.default_rng(2)
        x_q = rng.integers(-128, 128, size=(12, 33)).astype(np.int8)
        w_q = rng.integers(-128, 128, size=(33, 7)).astype(np.int8)
        a = np.float32(0.03)
        ws = rng.uniform(1e-3, 1e-2, size=(7,)).astype(np.float32)
        got = ref.int8_matmul_ref(t(x_q), t(w_q), torch.tensor([a]), t(ws),
                                  rows_per_lane=12)
        want = jref.int8_matmul_ref(jnp.asarray(x_q), jnp.asarray(w_q),
                                    jnp.asarray(a * ws[None, :]))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_wrapper_rejects_bad_input(self):
        x_q = torch.zeros(8, 4, dtype=torch.int8)
        w_q = torch.zeros(4, 3, dtype=torch.int8)
        s = torch.ones(3)
        with pytest.raises(ValueError, match="divide"):
            i8_mod.int8_matmul_cuda(x_q, w_q, torch.ones(3), s, 3)
        with pytest.raises(ValueError, match="int8 operands"):
            i8_mod.int8_matmul_cuda(x_q.float(), w_q, torch.ones(1), s, 8)
        with pytest.raises(ValueError, match="CUDA"):
            i8_mod.int8_matmul_cuda(x_q, w_q, torch.ones(1), s, 8)

    @pytest.mark.cuda
    @pytest.mark.parametrize("m,k,n,lanes", [(4 * 4096, 64, 64, 4),
                                             (4 * 512, 512, 512, 4),
                                             (4, 512, 512, 4),
                                             (3 * 77, 3, 33, 3)])
    def test_kernel_bitwise_on_card(self, cuda_device, m, k, n, lanes):
        g = torch.Generator().manual_seed(m + k)
        x = torch.randn(m, k, generator=g).to(cuda_device)
        w_q = torch.randint(-127, 128, (k, n), generator=g,
                            dtype=torch.int8).to(cuda_device)
        ws = (torch.rand(1, n, generator=g) / 127).to(cuda_device)
        before = i8_mod.int8_matmul_cuda.launches
        got = ops.int8_matmul(x, w_q, ws, lanes=lanes)
        x_q, a_scale = ops.quantize_activations(x, 8, lanes)
        want = ref.int8_matmul_ref(x_q, w_q, a_scale, ws.reshape(-1),
                                   m // lanes)
        torch.cuda.synchronize()
        assert i8_mod.int8_matmul_cuda.launches == before + 1
        assert torch.equal(got, want)


# ------------------------------------------------------- fused linear --

class TestFusedLinear:
    @pytest.mark.parametrize("act", ["relu", "gelu", "none"])
    @pytest.mark.parametrize("m,k,n", [(64, 3, 16), (50, 96, 40)])
    def test_matches_jax(self, act, m, k, n):
        rng = np.random.default_rng(m * k + n)
        x = rng.standard_normal((m, k)).astype(np.float32)
        w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
        b = rng.standard_normal(n).astype(np.float32)
        got = ops.fused_linear(t(x), t(w), t(b), act).numpy()
        want = jref.fused_linear_ref(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), act)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        pallas = fused_linear_pallas(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), activation=act,
                                     interpret=True)
        np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-5,
                                   atol=1e-5)

    def test_leading_dims_and_bad_activation(self):
        x = torch.randn(2, 3, 4, 8)
        y = ops.fused_linear(x, torch.randn(8, 5), torch.zeros(5), "none")
        assert y.shape == (2, 3, 4, 5)
        with pytest.raises(ValueError, match="activation"):
            ref.fused_linear_ref(x, torch.randn(8, 5), torch.zeros(5),
                                 "tanh")
        with pytest.raises(ValueError, match="CUDA"):
            fl_mod.fused_linear_cuda(x.reshape(-1, 8), torch.randn(8, 5),
                                     torch.zeros(5))

    def test_mixed_devices_raise(self):
        with pytest.raises(ValueError, match="one CUDA device or all"):
            ops.fused_linear(torch.randn(2, 3), torch.randn(3, 2),
                             torch.zeros(2, device="meta"))

    @pytest.mark.cuda
    @pytest.mark.parametrize("act", ["relu", "gelu", "none"])
    @pytest.mark.parametrize("m,k,n", [(4 * 4096, 64, 64), (4 * 512, 512,
                                                            512),
                                       (77, 3, 33)])
    def test_kernel_on_card(self, cuda_device, act, m, k, n):
        g = torch.Generator().manual_seed(m + n)
        x = torch.randn(m, k, generator=g).to(cuda_device)
        w = (torch.randn(k, n, generator=g) / k ** 0.5).to(cuda_device)
        b = torch.randn(n, generator=g).to(cuda_device)
        got = ops.fused_linear(x, w, b, act)
        torch.testing.assert_close(got, ref.fused_linear_ref(x, w, b, act),
                                   rtol=1e-5, atol=1e-5)
        # a row's value does not depend on the rows around it
        torch.testing.assert_close(ops.fused_linear(x[5:6], w, b, act),
                                   got[5:6], rtol=0, atol=0)


# -------------------------------------------------------------- build --

class TestBuild:
    def test_signatures_match_the_sources(self):
        """Every ctypes signature names an ``extern "C"`` launch function
        of its source with as many parameters, and every source has one."""
        sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
        assert sources == sorted(_build.SIGNATURES)
        for name, (symbol, argtypes) in _build.SIGNATURES.items():
            text = (_build.CSRC / f"{name}.cu").read_text()
            m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", text)
            assert m, f"{name}.cu has no extern C {symbol}"
            assert len(m.group(1).split(",")) == len(argtypes)

    def test_build_target_tracks_source_and_flags(self, monkeypatch):
        out, flags = _build._target("knn")
        assert "--fmad=false" in flags and "sm_90a" in " ".join(flags)
        assert out.parent == _build.BUILD_DIR
        monkeypatch.setitem(_build.EXTRA_FLAGS, "knn", ["-lineinfo"])
        assert _build._target("knn")[0] != out

    def test_launch_error_code_raises(self):
        _build.check("knn", 0)
        with pytest.raises(RuntimeError, match="CUDA error 9"):
            _build.check("knn", 9)

    def test_build_dir_is_ignored_by_git(self):
        root = pathlib.Path(__file__).resolve().parents[1]
        assert _build.BUILD_DIR.is_relative_to(root / "build")
        assert "build/" in (root / ".gitignore").read_text().split()
