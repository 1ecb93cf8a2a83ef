"""Parity of the port's Whisper encoder-decoder and its layers with
``repro``: LayerNorm, tanh-GELU, the k = 3 conv1d (and its stride-2
"SAME" padding), the audio frontend, sinusoids, the cross-attention
cache, forward, prefill, decode, ``loss_fn`` and ``Engine.generate``.

Both packages run the JAX smoke config of ``whisper-tiny`` (2 encoder
and 2 decoder layers, d_model 64, 4 heads, 16 stub frames, vocab 512,
tied embeddings) on the same parameters (drawn by the JAX init, carried
across through ``repro_torch.convert``) and the same inputs
(``np.random.default_rng``).

Tolerances, as ``tests/test_torch_lm.py`` states them: float32 rtol 1e-4
and atol 1e-4 * max|value| (greedy ids equal); bfloat16 atol 4e-2 *
max|logit|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.models.api import get_model as jax_get_model
from repro.serve.engine import Engine as JaxEngine
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import from_numpy_tree
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from repro_torch.models.api import get_model
from repro_torch.serve.engine import Engine

ARCH = "whisper-tiny"
B, T, S_ENC = 2, 12, 16
RTOL = 1e-4
BF16_ATOL = 4e-2

jax_init = jax.jit(JE.encdec_init, static_argnums=1)
jax_forward = jax.jit(JE.encdec_forward, static_argnums=1)
jax_prefill = jax.jit(JE.encdec_prefill, static_argnums=1)
jax_decode = jax.jit(JE.encdec_decode_step, static_argnums=1)


def configs(**over):
    return jax_smoke(ARCH).replace(**over), get_smoke_config(ARCH).replace(
        **over)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port(tree):
    return from_numpy_tree(np_tree(tree))


def close(got, want, dtype="float32", rtol=RTOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = np.abs(want).max()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL * scale)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((B, S_ENC, 64)).astype(np.float32),
            rng.integers(0, 512, (B, T)).astype(np.int32))


@pytest.fixture(scope="module")
def jax_params():
    """JAX smoke params per dtype, drawn once."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            cache[dtype] = jax_init(jax.random.PRNGKey(2),
                                    jax_smoke(ARCH).replace(dtype=dtype))
        return cache[dtype]
    return get


def torch_batch(frames, ids):
    return {"frames": torch.from_numpy(frames),
            "tokens": torch.from_numpy(ids).long()}


# -------------------------------------------------------------- layers --

class TestLayers:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_layernorm(self, dtype):
        rng = np.random.default_rng(1)
        x = (3 * rng.standard_normal((4, 5, 48)) + 1).astype(np.float32)
        g, b = (rng.standard_normal(48).astype(np.float32) for _ in range(2))
        jd, td = jnp.dtype(dtype), getattr(torch, dtype)
        want = JL.layernorm_apply({"g": jnp.asarray(g, jd),
                                   "b": jnp.asarray(b, jd)},
                                  jnp.asarray(x, jd), 1e-5)
        got = TL.layernorm_apply({"g": torch.from_numpy(g).to(td),
                                  "b": torch.from_numpy(b).to(td)},
                                 torch.from_numpy(x).to(td), 1e-5)
        assert got.dtype == td
        if dtype == "float32":
            close(got, want, rtol=1e-5)
        else:
            # f32 statistics, one rounding to bf16, then the affine in bf16
            assert np.array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_gelu_is_the_tanh_form(self, dtype):
        x = np.linspace(-6, 6, 2001).astype(np.float32)
        jd, td = jnp.dtype(dtype), getattr(torch, dtype)
        want = jax.nn.gelu(jnp.asarray(x, jd))
        got = TL.gelu(torch.from_numpy(x).to(td))
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)
            exact = torch.nn.functional.gelu(torch.from_numpy(x))
            assert (got - exact).abs().max() > 1e-4     # not the erf form
        else:
            # the port rounds the f32 tanh-GELU of the bf16 input once:
            # within half a bf16 step (2**-8 relative) of it
            want32 = np.asarray(jax.nn.gelu(
                jnp.asarray(x, jd).astype(jnp.float32)))
            np.testing.assert_allclose(got.float().numpy(), want32,
                                       rtol=2 ** -8, atol=1e-6)
            # JAX's bf16 chain rounds at every op (cancellation near the
            # negative tail): within a bf16 step or 4e-3 of the port
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want.astype(jnp.float32)),
                                       rtol=2 ** -7, atol=4e-3)

    @pytest.mark.parametrize("t,stride", [(9, 1), (9, 2), (10, 2), (1, 2)])
    @pytest.mark.parametrize("batched", [True, False])
    def test_conv1d_k3_same_padding(self, t, stride, batched):
        """XLA's "SAME" pads (pad // 2, the rest): uneven at stride 2, so
        an odd and an even length differ in where the taps land."""
        rng = np.random.default_rng(t + stride)
        x = rng.standard_normal((2, t, 5) if batched else (t, 5)).astype(
            np.float32)
        w = rng.standard_normal((3, 5, 7)).astype(np.float32)
        b = rng.standard_normal(7).astype(np.float32)
        want = JL.conv1d_apply({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                               jnp.asarray(x), stride=stride)
        got = TL.conv1d_apply({"w": torch.from_numpy(w),
                               "b": torch.from_numpy(b)},
                              torch.from_numpy(x), stride=stride)
        assert tuple(got.shape) == want.shape
        close(got, want, rtol=1e-5)

    def test_conv1d_init_shapes(self):
        g = torch.Generator().manual_seed(0)
        p = TL.conv1d_init(g, 80, 64, ksize=3, dtype=torch.bfloat16)
        assert p["w"].shape == (3, 80, 64) and p["w"].dtype == torch.bfloat16
        assert p["b"].dtype == torch.bfloat16
        assert TL.conv1d_init(g, 8, 4)["w"].shape == (8, 4)
        pw = {"w": torch.randn(5, 3, generator=g)}
        x = torch.randn(2, 7, 5, generator=g)
        assert torch.equal(TL.conv1d_apply(pw, x, stride=2),
                           (x @ pw["w"])[:, ::2])

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_audio_frontend_stride2_odd_frames(self, dtype):
        jcfg, tcfg = configs(dtype=dtype)
        params = JE.audio_frontend_init(jax.random.PRNGKey(3), jcfg,
                                        n_mels=16)
        mel = np.random.default_rng(4).standard_normal(
            (B, 31, 16)).astype(np.float32)
        want = JE.audio_frontend_apply(params, jnp.asarray(mel))
        got = TE.audio_frontend_apply(port(params), torch.from_numpy(mel))
        assert got.shape == (B, 16, 64) and want.shape == (B, 16, 64)
        close(got, want, dtype, rtol=1e-5)
        tp = TE.audio_frontend_init(torch.Generator().manual_seed(0), tcfg,
                                    n_mels=16)
        assert {k: tuple(v["w"].shape) for k, v in tp.items()} == {
            "conv1": (3, 16, 64), "conv2": (3, 64, 64)}

    def test_sinusoids(self):
        """Arguments up to 447 radians: the f32 sines differ by about an
        ulp of the argument (3e-5), inside 1e-4."""
        close(TE.sinusoids(448, 384), JE.sinusoids(448, 384))
        for pos in (0, 7, 447):
            close(TE.sinusoid_at(pos, 384), JE.sinusoid_at(pos, 384))


# --------------------------------------------------------------- model --

class TestWhisper:
    def test_configs_mirror_jax(self):
        for t_fn, j_fn in ((get_config, jax_config),
                           (get_smoke_config, jax_smoke)):
            tc = dataclasses.asdict(t_fn(ARCH))
            jc = dataclasses.asdict(j_fn(ARCH))
            tc.pop("quant"), jc.pop("quant")
            assert tc == jc

    @pytest.mark.parametrize("impl", ["xla", "flash"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_forward_matches_jax(self, jax_params, inputs, impl, dtype):
        """The flash route: the encoder's non-causal and the decoder's
        causal self-attention through JAX's Pallas kernel (interpret
        mode) and the port's plain version."""
        jcfg, tcfg = configs(dtype=dtype, attn_impl=impl)
        frames, ids = inputs
        params = jax_params(dtype)
        want, _ = jax_forward(params, jcfg, jnp.asarray(frames),
                              jnp.asarray(ids))
        got, aux = get_model(tcfg).forward(port(params),
                                           torch_batch(frames, ids))
        assert got.dtype == torch.float32 and got.shape == (B, T, 512)
        assert aux.item() == 0.0
        close(got, want, dtype)

    def test_encoder_matches_jax(self, jax_params, inputs):
        jcfg, tcfg = configs(dtype="float32")
        params = jax_params("float32")
        want = JE.encode(params, jcfg, jnp.asarray(inputs[0]))
        got = TE.encode(port(params), tcfg, torch.from_numpy(inputs[0]))
        close(got, want)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_prefill_decode_and_cross_cache(self, jax_params, inputs,
                                            dtype):
        """Prefill computes each layer's cross K/V once and carries them;
        4 decode steps read them, fed JAX's tokens; logits at every step
        and the final cache against JAX's."""
        jcfg, tcfg = configs(dtype=dtype)
        frames, ids = inputs
        params = jax_params(dtype)
        max_len = T + 4
        jcache = JE.encdec_init_cache(jcfg, B, max_len)
        jl, jcache = jax_prefill(params, jcfg, jnp.asarray(frames),
                                 jnp.asarray(ids), jcache)
        tp = port(params)
        api = get_model(tcfg)
        cache = api.init_cache(B, max_len, device="cpu")
        assert cache["cross_k"].shape == (2, B, S_ENC, 4, 16)
        got, cache = api.prefill(tp, torch_batch(frames, ids), cache)
        close(got, jl, dtype)
        for i in range(4):
            tok = jnp.argmax(jl, -1).astype(jnp.int32)
            jl, jcache = jax_decode(params, jcfg, tok, jnp.asarray(T + i),
                                    jcache)
            got, cache = api.decode_step(
                tp, {"token": torch.from_numpy(np.array(tok)).long(),
                     "pos": T + i}, cache)
            close(got, jl, dtype)
        for key in ("cross_k", "cross_v"):
            close(cache[key], jcache[key], dtype)
        for key in ("k", "v"):
            close(cache["self"][key], jcache["self"][key], dtype)

    def test_loss_fn_matches_jax(self, jax_params, inputs):
        jcfg, tcfg = configs(dtype="float32")
        frames, ids = inputs
        params = jax_params("float32")
        labels = np.roll(ids, -1, axis=1)
        want, _ = jax_get_model(jcfg).loss_fn(
            params, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(ids),
                     "labels": jnp.asarray(labels)})
        got, m = get_model(tcfg).loss_fn(
            port(params), dict(torch_batch(frames, ids),
                               labels=torch.from_numpy(labels).long()))
        assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
        assert set(m) == {"loss", "ce", "moe_aux"}

    def test_engine_passes_frames_and_matches_jax(self, jax_params, inputs):
        """Engine.generate hands the whole batch (frames and tokens) to
        prefill, as JAX's engine does: the same greedy ids; and the last
        decode step's logits and argmax equal the forward's on the
        extended tokens."""
        jcfg, tcfg = configs(dtype="float32")
        frames, ids = inputs
        params = jax_params("float32")
        n_gen = 5
        want = JaxEngine(jax_get_model(jcfg), params, max_len=T + n_gen,
                         batch_size=B).generate(
            {"frames": jnp.asarray(frames), "tokens": jnp.asarray(ids)},
            n_gen)
        api = get_model(tcfg)
        tp = port(params)
        out = Engine(api, tp, max_len=T + n_gen, batch_size=B,
                     device="cpu").generate(torch_batch(frames, ids), n_gen)
        assert np.array_equal(out["ids"].numpy(), np.asarray(want["ids"]))
        full, _ = api.forward(tp, {
            "frames": torch.from_numpy(frames),
            "tokens": torch.cat([torch.from_numpy(ids).long(), out["ids"]],
                                dim=1)})
        close(out["logits"], full[:, -1].numpy())
        assert torch.equal(out["logits"].argmax(-1), full[:, -1].argmax(-1))

    def test_dense_cache_bounds_generation(self, jax_params, inputs):
        """The decoder's self cache holds positions: a prompt plus steps
        past max_len raise; an exact fit works."""
        _, tcfg = configs(dtype="float32")
        eng = Engine(get_model(tcfg), port(jax_params("float32")),
                     max_len=T + 3, batch_size=B, device="cpu")
        with pytest.raises(ValueError, match=f"max_len is {T + 3}"):
            eng.generate(torch_batch(*inputs), 4)
        assert eng.generate(torch_batch(*inputs), 3)["ids"].shape == (B, 3)
