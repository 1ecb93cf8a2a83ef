"""Parity of the LM kernels' plain versions with ``repro.kernels``.

On the CPU, ``repro_torch.kernels.ops.flash_attention`` runs
``ref.attention_ref`` and ``ops.w8_matmul`` runs ``ref.w8_matmul_plain``;
these tests hold them against the JAX package's Pallas kernels in
interpret mode (and its ``attention_ref`` oracle) on inputs drawn with
numpy.  Tolerances:

* attention, f32: rtol = atol = 1e-5.  The Pallas kernel scales q before
  the dot and runs an online softmax over 64-key tiles; the plain version
  divides the logits and takes one softmax, so the two differ by f32
  rounding only (about 1e-7 on these O(1) outputs).
* attention, bf16: the outputs are rounded to bf16, so a value near a
  rounding boundary may land one bf16 step (2**-8 relative) away:
  rtol = 2**-7, atol = 2**-7 * max|out|.
* w8 matmul, f32: rtol 1e-5, atol 1e-5 * max|out| (f32 sums over K in
  another order).  bf16: one bf16 step, as for attention.

The tensor-core route of the CUDA kernel (bf16, D = 64 and 128) rounds at
two other points than the Pallas kernel: it scales the f32 logits after
the product (not q before it), and it rounds P to bf16 before P V (f32
sums).  ``wgmma_route_emulation`` repeats that arithmetic in plain torch,
so the CPU can tell how much of the card check's allowance it uses.

Tests marked ``cuda`` hold the CUDA kernels against the same plain
versions on the card and skip where no GPU is present.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.int8_matmul import w8_matmul_pallas
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import int8_matmul as i8_mod
from repro_torch.kernels import ops, ref

BF16_REL = 2.0 ** -7

# (B, H, Hkv, Tq, Tk, D, causal, window): the cases of
# tests/test_kernels.py::TestFlashAttention (GQA 8/2, Tq != Tk, Tq = 1,
# window, non-causal, MHA) plus the LM smoke configs' head dim.
ATTN_CASES = [
    (2, 8, 2, 128, 128, 64, True, 0),
    (2, 8, 2, 200, 200, 64, True, 0),
    (2, 8, 2, 64, 256, 64, True, 0),
    (2, 8, 2, 200, 200, 64, False, 0),
    (2, 8, 2, 200, 200, 64, True, 64),
    (2, 8, 2, 1, 200, 64, True, 0),
    (2, 4, 4, 96, 96, 32, True, 0),
    (2, 4, 2, 24, 24, 16, True, 8),
]


def qkv(case, dtype=np.float32, seed=0):
    b, h, hkv, tq, tk, d = case[:6]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, tk, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, tk, d)).astype(np.float32)
    return q, k, v


def to_jax(a, dtype):
    return jnp.asarray(a).astype(dtype)


def to_torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


def close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "bf16":
        np.testing.assert_allclose(
            got, want, rtol=BF16_REL, atol=BF16_REL * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def rowwise_worst(got, want, tol=BF16_REL):
    """The largest |got - want| / (tol |want| + tol max|want| of its row):
    the card check's ratio (``chip_smoke.py``'s ``rowwise_close``)."""
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    allowed = tol * np.abs(w) + tol * np.abs(w).max(-1, keepdims=True)
    diff = np.abs(g - w)
    ratio = np.where(allowed > 0, diff / np.maximum(allowed, 1e-30),
                     np.where(diff > 0, np.inf, 0.0))
    return float(ratio.max())


def wgmma_route_emulation(q, k, v, causal, window, bkv=128):
    """The tensor-core route's arithmetic in plain torch, tile by tile:
    f32 logits of the raw bf16 q and k scaled by sm_scale * log2(e)
    afterwards, exp2 in an online softmax over ``bkv``-key tiles, P rounded
    to bf16 before P V with f32 sums, the normalizer summed from the f32
    P, bf16 out."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    rep = h // k.shape[1]
    qf = q.float()
    kf = k.repeat_interleave(rep, dim=1).float()
    vf = v.repeat_interleave(rep, dim=1).float()
    scale = torch.tensor(np.float32(1.0 / d ** 0.5)
                         * np.float32(1.4426950408889634))
    neg = torch.tensor(-1e30)
    qpos = torch.arange(tq)[:, None] + (tk - tq)
    m = torch.full((b, h, tq, 1), -1e30)
    l = torch.zeros((b, h, tq, 1))
    acc = torch.zeros((b, h, tq, d))
    for k_lo in range(0, tk, bkv):
        kpos = torch.arange(k_lo, min(k_lo + bkv, tk))[None, :]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, k_lo:k_lo + bkv])
        mask = torch.ones(s.shape[-2:], dtype=torch.bool)
        if causal:
            mask &= kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        s = torch.where(mask, s * scale, neg)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(mask, torch.exp2(s - m_new), 0.0)
        alpha = torch.exp2(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(),
            vf[:, :, k_lo:k_lo + bkv])
        m = m_new
    return (acc / torch.where(l == 0, 1.0, l)).to(torch.bfloat16)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# ---------------------------------------------------------- attention --

class TestAttention:
    @pytest.mark.parametrize("case", ATTN_CASES)
    def test_plain_matches_jax_ref_and_pallas(self, case):
        causal, window = case[6], case[7]
        q, k, v = qkv(case)
        tq_ = torch.from_numpy
        got_ref = ref.attention_ref(tq_(q), tq_(k), tq_(v), causal, window)
        got_ops = ops.flash_attention(tq_(q), tq_(k), tq_(v), causal, window)
        jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
        want_ref = jref.attention_ref(jq, jk, jv, causal=causal,
                                      sliding_window=window)
        want_pallas = flash_attention_pallas(jq, jk, jv, causal=causal,
                                             window=window, tq=64, tk=64,
                                             interpret=True)
        close(got_ref, want_ref, "f32")
        close(got_ops, want_pallas, "f32")
        assert torch.equal(got_ref, got_ops)

    @pytest.mark.parametrize("case", [ATTN_CASES[1], ATTN_CASES[5],
                                      (1, 4, 4, 128, 128, 32, True, 0)])
    def test_bf16(self, case):
        causal, window = case[6], case[7]
        q, k, v = qkv(case, seed=1)
        got = ops.flash_attention(to_torch(q, torch.bfloat16),
                                  to_torch(k, torch.bfloat16),
                                  to_torch(v, torch.bfloat16), causal, window)
        assert got.dtype == torch.bfloat16
        want = flash_attention_pallas(
            to_jax(q, jnp.bfloat16), to_jax(k, jnp.bfloat16),
            to_jax(v, jnp.bfloat16), causal=causal, window=window,
            interpret=True)
        close(got.float(), want, "bf16")

    @pytest.mark.parametrize("case", [(1, 8, 2, 512, 512, 64, True, 0),
                                      (1, 4, 2, 384, 384, 128, True, 0),
                                      (1, 8, 2, 512, 512, 64, True, 200)])
    def test_tensor_core_rounding_fits_the_card_check(self, case):
        """The tensor-core route's rounding points, emulated, against the
        Pallas kernel on bf16 inputs under the card check's allowance."""
        causal, window = case[6], case[7]
        q, k, v = qkv(case, seed=2)
        got = wgmma_route_emulation(*(to_torch(a, torch.bfloat16)
                                      for a in (q, k, v)), causal, window)
        want = flash_attention_pallas(
            to_jax(q, jnp.bfloat16), to_jax(k, jnp.bfloat16),
            to_jax(v, jnp.bfloat16), causal=causal, window=window,
            interpret=True)
        assert rowwise_worst(got.float(), want) <= 1.0

    def test_fully_masked_rows_follow_the_oracle(self):
        """Tq > Tk under the causal mask leaves the first rows with no key:
        the oracle's softmax over all -1e30 averages v (the Pallas kernel
        writes 0 there; the LM never makes such a call)."""
        q, k, v = qkv((1, 2, 2, 8, 4, 16))
        got = ref.attention_ref(*map(torch.from_numpy, (q, k, v)))
        want = jref.attention_ref(*map(jnp.asarray, (q, k, v)))
        close(got, want, "f32")

    def test_kernel_wrapper_rejects_bad_input(self):
        q = torch.zeros(1, 4, 8, 64)
        k = torch.zeros(1, 2, 8, 64)
        with pytest.raises(ValueError, match="CUDA"):
            fa_mod.flash_attention_cuda(q, k, k)
        with pytest.raises(ValueError, match="head dims"):
            fa_mod.flash_attention_cuda(q[..., :48], k[..., :48],
                                        k[..., :48])
        with pytest.raises(ValueError, match="multiple of Hkv"):
            fa_mod.flash_attention_cuda(torch.zeros(1, 3, 8, 64), k, k)
        with pytest.raises(ValueError, match="bf16 or f32"):
            fa_mod.flash_attention_cuda(q.half(), k.half(), k.half())
        with pytest.raises(ValueError, match="one CUDA device"):
            ops.flash_attention(q, k, torch.zeros(1, 2, 8, 64,
                                                  device="meta"))

    @pytest.mark.parametrize("d", fa_mod.HEAD_DIMS)
    def test_kernel_wrapper_takes_every_head_dim(self, d):
        """D = 16 included: a CPU tensor of any head dim the kernel takes
        is refused for its device, not its head dim."""
        q = torch.zeros(1, 4, 8, d, dtype=torch.bfloat16)
        k = torch.zeros(1, 2, 8, d, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="contiguous CUDA tensors"):
            fa_mod.flash_attention_cuda(q, k, k)

    def test_route_is_fixed_by_dtype_and_head_dim(self):
        assert [fa_mod.route(torch.bfloat16, d) for d in fa_mod.HEAD_DIMS] \
            == ["ffma", "ffma", "wgmma", "wgmma"]
        assert {fa_mod.route(torch.float32, d) for d in fa_mod.HEAD_DIMS} \
            == {"ffma"}

    @pytest.mark.cuda
    @pytest.mark.parametrize("case", ATTN_CASES + [
        (4, 32, 4, 2048, 2048, 64, True, 0),
        (2, 8, 2, 256, 256, 128, True, 0)])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_kernel_matches_plain_on_card(self, cuda_device, case, dtype):
        causal, window = case[6], case[7]
        q, k, v = (to_torch(a, dtype).to(cuda_device) for a in qkv(case))
        before = fa_mod.flash_attention_cuda.launches
        got = ops.flash_attention(q, k, v, causal, window)
        want = ref.attention_ref(q, k, v, causal, window)
        torch.cuda.synchronize()
        assert fa_mod.flash_attention_cuda.launches == before + 1
        close(got.float().cpu(), want.float().cpu(),
              "bf16" if dtype == torch.bfloat16 else "f32")

    @pytest.mark.cuda
    def test_non_default_tiles_raise_on_card(self, cuda_device):
        q = torch.zeros(1, 2, 8, 64, device=cuda_device)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ops.flash_attention(q, q, q, tq=64, tk=64)


# ---------------------------------------------------------------- w8 ---

def w8_inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w_q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = (rng.random((1, n)) / 127 + 1e-4).astype(np.float32)
    return x, w_q, scale


class TestW8Matmul:
    @pytest.mark.parametrize("m,k,n", [(4, 256, 384), (37, 100, 70),
                                       (130, 64, 200)])
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_plain_matches_pallas_interpret(self, m, k, n, dtype):
        x, w_q, scale = w8_inputs(m, k, n)
        jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                    else (jnp.bfloat16, torch.bfloat16))
        want = w8_matmul_pallas(to_jax(x, jdt), jnp.asarray(w_q),
                                jnp.asarray(scale), interpret=True)
        got = ref.w8_matmul_plain(to_torch(x, tdt), torch.from_numpy(w_q),
                                  torch.from_numpy(scale))
        assert got.dtype == tdt
        close(got.float(), want, dtype)

    def test_ops_keeps_leading_dims(self):
        x, w_q, scale = w8_inputs(12, 32, 16)
        xt = torch.from_numpy(x)
        got = ops.w8_matmul(xt.reshape(3, 4, 32), torch.from_numpy(w_q),
                            torch.from_numpy(scale))
        want = ref.w8_matmul_plain(xt, torch.from_numpy(w_q),
                                   torch.from_numpy(scale))
        assert got.shape == (3, 4, 16)
        assert torch.equal(got.reshape(12, 16), want)

    def test_kernel_wrapper_rejects_bad_input(self):
        x, w_q, scale = map(torch.from_numpy, w8_inputs(4, 8, 6))
        with pytest.raises(ValueError, match="CUDA"):
            i8_mod.w8_matmul_cuda(x, w_q, scale)
        with pytest.raises(ValueError, match="needs w_q"):
            i8_mod.w8_matmul_cuda(x, w_q[:5], scale)
        with pytest.raises(ValueError, match="int8 w_q"):
            i8_mod.w8_matmul_cuda(x, w_q.float(), scale)
        with pytest.raises(ValueError, match="6 entries"):
            i8_mod.w8_matmul_cuda(x, w_q, scale[:, :5])

    @pytest.mark.cuda
    @pytest.mark.parametrize("m,k,n", [(4, 2048, 5632), (37, 100, 70),
                                       (512, 2048, 5632)])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_kernel_matches_plain_on_card(self, cuda_device, m, k, n, dtype):
        x, w_q, scale = w8_inputs(m, k, n)
        x = to_torch(x, dtype).to(cuda_device)
        w_q = torch.from_numpy(w_q).to(cuda_device)
        scale = torch.from_numpy(scale).to(cuda_device)
        before = i8_mod.w8_matmul_cuda.launches
        got = ops.w8_matmul(x, w_q, scale)
        want = ref.w8_matmul_plain(x, w_q, scale)
        torch.cuda.synchronize()
        assert i8_mod.w8_matmul_cuda.launches == before + 1
        close(got.float().cpu(), want.float().cpu(),
              "bf16" if dtype == torch.bfloat16 else "f32")
