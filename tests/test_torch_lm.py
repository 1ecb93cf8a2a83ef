"""Parity of the port's decoder LM (``repro_torch``) with ``repro``.

The JAX package's smoke configs (2 layers, d_model 64, 4 query heads over
2 KV heads, vocab 512) of ``tinyllama-1.1b`` and ``llama3.2-1b`` (tied
embeddings, rope_theta 500000) are run by both packages on the same
parameters (drawn by the JAX ``lm_init`` and carried across through
``repro_torch.convert``) and the same token ids (``np.random.
default_rng``).  JAX's flash route runs the Pallas kernel in interpret
mode; the port's runs the kernel's plain version on the CPU.

Tolerances:

* float32 (``cfg.replace(dtype="float32")``): rtol 1e-4 and atol 1e-4 *
  max|logit|; greedy ids are equal.
* bfloat16: atol 4e-2 * max|logit|.  One block run op by op is bitwise
  equal to JAX's (``test_block_bitwise_eager``); but the JAX forward
  scans a compiled block, and XLA's CPU compiler fuses elementwise
  chains and rounds to bf16 once per fusion where each op rounds
  eagerly.  That moves hidden values by a bf16 step (2**-8 relative) here
  and there; over two layers the logits differ by about 1.1e-2 of their
  largest value, and 4e-2 leaves room for other draws.
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
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core.quant import QuantConfig as JaxQuantConfig
from repro.core.quant import quantize_tree as jax_quantize_tree
from repro.models import transformer as JT
from repro.models.api import get_model as jax_get_model
from repro.serve.engine import Engine as JaxEngine
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import from_numpy_tree
from repro_torch.core.quant import QuantConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.models.api import get_model
from repro_torch.serve.engine import Engine
from repro_torch.sharding.context import use_mesh

ARCHS = ["tinyllama-1.1b", "llama3.2-1b"]
B, T = 2, 24
RTOL = 1e-4
BF16_ATOL = 4e-2


# jitted JAX init and serve steps (the config is static): one compile per
# config in place of many eager op dispatches
jax_init = jax.jit(JT.lm_init, static_argnums=1)
jax_prefill = jax.jit(JT.lm_prefill, static_argnums=1)
jax_decode = jax.jit(JT.lm_decode_step, static_argnums=1)


def configs(arch, **over):
    return (jax_smoke(arch).replace(**over),
            get_smoke_config(arch).replace(**over))


def assert_logits(got, want, dtype="float32"):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL * scale)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def ids():
    return np.random.default_rng(0).integers(0, 512, (B, T)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_params():
    """JAX smoke params per (arch, dtype), drawn once."""
    cache = {}

    def get(arch, dtype):
        if (arch, dtype) not in cache:
            jcfg = jax_smoke(arch).replace(dtype=dtype)
            cache[arch, dtype] = jax_init(jax.random.PRNGKey(0), jcfg)
        return cache[arch, dtype]
    return get


def port(tree):
    return from_numpy_tree(np_tree(tree))


# ------------------------------------------------------------ configs --

class TestConfigs:
    def test_fields_mirror_jax(self):
        """The port's fields are JAX's, in JAX's order and with its
        defaults (the encoder-decoder and SSM ones included); ``quant``
        is the port's own QuantConfig."""
        jf = [(f.name, f.default) for f in dataclasses.fields(JaxModelConfig)
              if f.name != "quant"]
        tf = [(f.name, f.default) for f in dataclasses.fields(ModelConfig)
              if f.name != "quant"]
        assert tf == jf
        assert [f.name for f in dataclasses.fields(ModelConfig)] == [
            f.name for f in dataclasses.fields(JaxModelConfig)]
        q = ModelConfig.__dataclass_fields__["quant"].default
        assert (q.w_bits, q.a_bits, q.enabled) == (32, 32, False)

    @pytest.mark.parametrize("arch", ARCHS)
    def test_archs_mirror_jax(self, arch):
        from repro.configs import get_config as jax_get_config
        for t_fn, j_fn in ((get_config, jax_get_config),
                           (get_smoke_config, jax_smoke)):
            tc, jc = dataclasses.asdict(t_fn(arch)), dataclasses.asdict(
                j_fn(arch))
            tc.pop("quant")
            assert tc == {n: jc[n] for n in tc}
        from repro.configs import list_archs as jax_list_archs
        assert list_archs() == jax_list_archs()

    def test_tinyllama_full_shape(self):
        cfg = get_config("tinyllama-1.1b")
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                cfg.d_ff, cfg.vocab_size, cfg.kv_head_dim) == (
            22, 2048, 32, 4, 5632, 32000, 64)
        assert get_config("llama3.2-1b").tie_embeddings

    def test_unported_and_unknown_archs(self):
        """Every one of JAX's ten archs resolves, full and smoke, to JAX's
        values (the shape fields ``tests/test_models.py`` pins among
        them); an unknown arch raises ``KeyError``."""
        from repro.configs import get_config as jax_get_config
        shape = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                 "vocab_size")
        for arch in list_archs():
            for t_fn, j_fn in ((get_config, jax_get_config),
                               (get_smoke_config, jax_smoke)):
                tc = dataclasses.asdict(t_fn(arch))
                jc = dataclasses.asdict(j_fn(arch))
                assert [tc[f] for f in shape] == [jc[f] for f in shape]
                tc.pop("quant"), jc.pop("quant")
                assert tc == jc, arch
        assert len(list_archs()) == 10
        with pytest.raises(KeyError, match="tinyllama"):
            get_config("gpt-5")


# ------------------------------------------------------------ convert --

class TestConvert:
    def test_bf16_tree_round_trips_bit_exactly(self, jax_params):
        tree = np_tree(jax_params("tinyllama-1.1b", "bfloat16"))
        got = from_numpy_tree(tree)
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        assert len(flat) == 12
        for path, leaf in flat:
            t = got
            for p in path:
                t = t[p.key]
            assert t.dtype == torch.bfloat16 and tuple(t.shape) == leaf.shape
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  leaf.view(np.int16))
        assert got["blocks"]["attn"]["wq"]["w"].shape == (2, 64, 64)

    def test_other_dtypes_unchanged(self):
        tree = {"a": np.arange(6, dtype=np.int8).reshape(2, 3),
                "b": np.float32(1.5), "c": np.arange(3, dtype=np.int32)}
        got = from_numpy_tree(tree)
        assert got["a"].dtype == torch.int8 and got["a"].tolist() == [
            [0, 1, 2], [3, 4, 5]]
        assert got["b"].dtype == torch.float32 and got["b"].item() == 1.5
        assert got["c"].dtype == torch.int32


# ------------------------------------------------------------ forward --

class TestForward:
    @pytest.mark.parametrize("arch", ARCHS)
    @pytest.mark.parametrize("impl", ["xla", "flash"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_forward_matches_jax(self, jax_params, ids, arch, impl, dtype):
        jcfg, tcfg = configs(arch, dtype=dtype, attn_impl=impl)
        params = jax_params(arch, dtype)
        want, _ = JT.lm_forward(params, jcfg, jnp.asarray(ids))
        got, aux = get_model(tcfg).forward(port(params),
                                           torch.from_numpy(ids).long())
        assert got.dtype == torch.float32 and got.shape == (B, T, 512)
        assert aux.item() == 0.0
        assert_logits(got, want, dtype)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_block_bitwise_eager(self, jax_params, ids, dtype):
        """One block, op by op in JAX (no jit), equals the port's bit for
        bit; bf16 included (sigmoid follows XLA's CPU expansion)."""
        jcfg, tcfg = configs("tinyllama-1.1b", dtype=dtype)
        params = jax_params("tinyllama-1.1b", dtype)
        blk = jax.tree_util.tree_map(lambda a: a[0], params["blocks"])
        x = JT._embed_in(params, jcfg, jnp.asarray(ids))
        want, _, _ = JT._block_apply(blk, jcfg, x)
        tp = port(params)
        got, _, _ = TT._block_apply(TT.layer_params(tp["blocks"], 0), tcfg,
                                    TT._embed_in(tp, tcfg,
                                                 torch.from_numpy(ids).long()))
        want = np.asarray(want.astype(jnp.float32))
        got = got.float().numpy()
        if dtype == "bfloat16":
            assert np.array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("impl", ["xla", "flash"])
    def test_sliding_window_forward(self, ids, impl):
        jcfg, tcfg = configs("tinyllama-1.1b", dtype="float32",
                             attn_impl=impl, sliding_window=8)
        params = jax_init(jax.random.PRNGKey(3), jcfg)
        want, _ = JT.lm_forward(params, jcfg, jnp.asarray(ids))
        got, _ = TT.lm_forward(port(params), tcfg,
                               torch.from_numpy(ids).long())
        assert_logits(got, want)

    def test_float_inputs_pass_through(self, jax_params):
        jcfg, tcfg = configs("tinyllama-1.1b", dtype="float32")
        params = jax_params("tinyllama-1.1b", "float32")
        emb = np.random.default_rng(5).standard_normal(
            (B, 6, 64)).astype(np.float32)
        want, _ = JT.lm_forward(params, jcfg, jnp.asarray(emb))
        got, _ = TT.lm_forward(port(params), tcfg, torch.from_numpy(emb))
        assert_logits(got, want)

    def test_entry_points_sum_bf16_products_in_f32(self, jax_params, ids):
        """Forward, prefill and decode run with cuBLAS's reduced-precision
        bf16 reductions off, whatever the process-wide flag; the flag is
        restored after each call."""
        _, tcfg = configs("tinyllama-1.1b")
        api = get_model(tcfg)
        tp = port(jax_params("tinyllama-1.1b", "bfloat16"))
        x = torch.from_numpy(ids).long()
        m = torch.backends.cuda.matmul
        seen, real = [], TT._layers

        def spy(*a, **kw):
            seen.append(m.allow_bf16_reduced_precision_reduction)
            return real(*a, **kw)

        saved = m.allow_bf16_reduced_precision_reduction
        try:
            m.allow_bf16_reduced_precision_reduction = True
            TT._layers = spy
            api.forward(tp, x)
            cache = api.init_cache(B, T + 1, device="cpu")
            api.prefill(tp, {"tokens": x}, cache)
            api.decode_step(tp, {"token": x[:, 0], "pos": T}, cache)
            assert m.allow_bf16_reduced_precision_reduction
        finally:
            TT._layers = real
            m.allow_bf16_reduced_precision_reduction = saved
        assert seen == [False, False, False]

    def test_param_count(self, jax_params):
        params = jax_params("llama3.2-1b", "float32")
        assert TT.param_count(port(params)) == JT.param_count(params)


# -------------------------------------------------------- serve steps --

def jax_steps(jcfg, params, ids, n_decode):
    """JAX prefill, then ``n_decode`` decode steps each fed the argmax of
    the step before: (prefill logits, [decode logits], [fed tokens])."""
    cache = JT.lm_init_cache(jcfg, ids.shape[0], ids.shape[1] + n_decode)
    logits, cache = jax_prefill(params, jcfg, jnp.asarray(ids), cache)
    prefill, steps, toks = np.asarray(logits), [], []
    for i in range(n_decode):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks.append(np.array(tok))
        logits, cache = jax_decode(params, jcfg, tok,
                                   jnp.asarray(ids.shape[1] + i), cache)
        steps.append(np.asarray(logits))
    return prefill, steps, toks


def check_steps(jcfg, tcfg, params, ids, n_decode, dtype="float32"):
    """The port's prefill and decode steps, fed JAX's tokens, against
    JAX's logits at every step."""
    want_pre, want_steps, toks = jax_steps(jcfg, params, ids, n_decode)
    tp = port(params)
    cache = TT.lm_init_cache(tcfg, ids.shape[0], ids.shape[1] + n_decode)
    got, cache = TT.lm_prefill(tp, tcfg, torch.from_numpy(ids).long(), cache)
    assert_logits(got, want_pre, dtype)
    for i, (tok, want) in enumerate(zip(toks, want_steps)):
        got, cache = TT.lm_decode_step(tp, tcfg, torch.from_numpy(tok).long(),
                                       ids.shape[1] + i, cache)
        assert_logits(got, want, dtype)


class TestServeSteps:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_prefill_and_decode_match_jax(self, jax_params, ids, arch):
        jcfg, tcfg = configs(arch, dtype="float32")
        check_steps(jcfg, tcfg, jax_params(arch, "float32"), ids, 1)

    def test_rolling_cache_past_the_window(self, ids):
        """sliding_window=8: the prompt (12) already overruns the window,
        and 6 decode steps wrap the rolling slots again."""
        jcfg, tcfg = configs("tinyllama-1.1b", dtype="float32",
                             sliding_window=8)
        params = jax_init(jax.random.PRNGKey(4), jcfg)
        assert TT.lm_init_cache(tcfg, 2, 100)["k"].shape == (2, 2, 8, 2, 16)
        check_steps(jcfg, tcfg, params, ids[:, :12], 6)

    def test_w8_deployment(self, jax_params, ids):
        """JAX's int8 export (W8A16, ``int8_ref``) carried across: the int8
        weights are identical and the dequantized matmuls agree."""
        jq = JaxQuantConfig(w_bits=8, a_bits=16, backend="int8_ref")
        jcfg, tcfg = configs("tinyllama-1.1b", dtype="float32")
        jcfg = jcfg.replace(quant=jq)
        tcfg = tcfg.replace(quant=QuantConfig(w_bits=8, a_bits=16,
                                              backend="int8_ref"))
        qparams = jax_quantize_tree(jax_params("tinyllama-1.1b", "float32"),
                                    jq)
        tp = port(qparams)
        wq = tp["blocks"]["mlp"]["up"]["w"]
        assert wq["q"].dtype == torch.int8 and wq["q"].shape == (2, 64, 128)
        assert np.array_equal(
            wq["q"].numpy(), np.asarray(qparams["blocks"]["mlp"]["up"]["w"]
                                        ["q"]))
        want, _ = JT.lm_forward(qparams, jcfg, jnp.asarray(ids))
        got, _ = TT.lm_forward(tp, tcfg, torch.from_numpy(ids).long())
        assert_logits(got, want)
        check_steps(jcfg, tcfg, qparams, ids, 1)

    def test_bf16_steps_within_bound(self, jax_params, ids):
        jcfg, tcfg = configs("llama3.2-1b", dtype="bfloat16")
        check_steps(jcfg, tcfg, jax_params("llama3.2-1b", "bfloat16"), ids,
                    1, dtype="bfloat16")

    def test_cache_write_past_the_end_raises(self):
        _, tcfg = configs("tinyllama-1.1b", dtype="float32")
        cache = TA.init_cache(tcfg, 1, 8)
        p = TA.attn_init(torch.Generator().manual_seed(0), tcfg)
        x = torch.randn(1, 3, 64)
        TA.attn_apply(p, tcfg, x, cache=cache, cache_pos=5)      # fits
        with pytest.raises(ValueError, match="does not fit"):
            TA.attn_apply(p, tcfg, x, cache=cache, cache_pos=6)


# ------------------------------------------------------------- engine --

class TestEngine:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_greedy_ids_equal_jax_engine(self, jax_params, ids, arch):
        jcfg, tcfg = configs(arch, dtype="float32")
        params = jax_params(arch, "float32")
        n_gen = 6
        jeng = JaxEngine(jax_get_model(jcfg), params, max_len=T + n_gen,
                         batch_size=B)
        want = jeng.generate({"tokens": jnp.asarray(ids)}, n_gen)
        eng = Engine(get_model(tcfg), port(params), max_len=T + n_gen,
                     batch_size=B, device="cpu")
        got = eng.generate({"tokens": torch.from_numpy(ids).long()}, n_gen)
        assert np.array_equal(got["ids"].numpy(), np.asarray(want["ids"]))
        assert got["logits"].shape == (B, 512)
        st = got["stats"]
        assert st.tokens_out == B * n_gen and st.decode_tok_per_s > 0

    def test_last_logits_match_forward(self, jax_params, ids):
        """The last decode step's logits equal the forward's on the prompt
        extended by the generated ids (what the card's smoke checks)."""
        _, tcfg = configs("tinyllama-1.1b", dtype="float32",
                          attn_impl="flash")
        api = get_model(tcfg)
        tp = port(jax_params("tinyllama-1.1b", "float32"))
        prompt = torch.from_numpy(ids).long()
        out = Engine(api, tp, max_len=T + 4, batch_size=B,
                     device="cpu").generate({"tokens": prompt}, 4)
        full = torch.cat([prompt, out["ids"]], dim=1)
        want, _ = api.forward(tp, full)
        assert_logits(out["logits"], want[:, -1].numpy())

    def test_cache_too_small_raises_and_exact_fit_works(self, jax_params,
                                                        ids):
        _, tcfg = configs("tinyllama-1.1b", dtype="float32")
        tp = port(jax_params("tinyllama-1.1b", "float32"))
        prompt = torch.from_numpy(ids[:, :8]).long()
        eng = Engine(get_model(tcfg), tp, max_len=11, batch_size=B,
                     device="cpu")
        with pytest.raises(ValueError, match="max_len is 11"):
            eng.generate({"tokens": prompt}, 4)
        assert eng.generate({"tokens": prompt}, 3)["ids"].shape == (B, 3)

    def test_temperature_sampling_is_seeded(self, jax_params, ids):
        _, tcfg = configs("tinyllama-1.1b", dtype="float32")
        tp = port(jax_params("tinyllama-1.1b", "float32"))
        prompt = torch.from_numpy(ids[:, :8]).long()
        runs = [Engine(get_model(tcfg), tp, max_len=16, batch_size=B,
                       temperature=0.8, seed=s, device="cpu").generate(
            {"tokens": prompt}, 5)["ids"] for s in (1, 1)]
        assert torch.equal(runs[0], runs[1])
        assert runs[0].min() >= 0 and runs[0].max() < 512


# ------------------------------------------------------ rejections -----

class TestRejections:
    def test_unported_paths_name_roadmap(self, jax_params, ids):
        _, tcfg = configs("tinyllama-1.1b", dtype="float32")
        tp = port(jax_params("tinyllama-1.1b", "float32"))
        x = torch.from_numpy(ids).long()
        # seq_parallel runs where its constraint moves nothing, and raises
        # on real tensors an abstract 'model' axis would split (no process
        # holds a block there)
        sp = tcfg.replace(seq_parallel=True)
        assert torch.equal(TT.lm_forward(tp, sp, x)[0],
                           TT.lm_forward(tp, tcfg, x)[0])
        with use_mesh(Mesh(("data", "model"), (1, 2))):
            with pytest.raises(ValueError,
                               match="seq_parallel.*abstract mesh"):
                TT.lm_forward(tp, sp, x)
        with pytest.raises(ValueError, match="unknown family"):
            get_model(tcfg.replace(family="pointcloud"))
        with pytest.raises(ValueError, match="unknown attn_impl"):
            TT.lm_forward(tp, tcfg, x, impl="pallas")

    def test_entry_points_default_to_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        _, tcfg = configs("tinyllama-1.1b")
        api = get_model(tcfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            api.init(torch.Generator().manual_seed(0))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            api.init_cache(1, 8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Engine(api, {}, max_len=8, batch_size=1)
        params = api.init(torch.Generator().manual_seed(0), device="cpu")
        assert params["blocks"]["attn"]["wq"]["w"].dtype == torch.bfloat16
        assert params["blocks"]["attn"]["wq"]["w"].shape == (2, 64, 64)
        assert "unembed" in params

    def test_lm_modules_import_neither_jax_nor_repro(self):
        src = pathlib.Path(__file__).resolve().parents[1] / "src"
        mods = ["repro_torch.configs", "repro_torch.configs.tinyllama_1_1b",
                "repro_torch.configs.xlstm_1_3b",
                "repro_torch.configs.hymba_1_5b",
                "repro_torch.configs.whisper_tiny",
                "repro_torch.models.linear_scan", "repro_torch.models.xlstm",
                "repro_torch.models.hymba", "repro_torch.models.encdec",
                "repro_torch.configs.llama3_2_1b",
                "repro_torch.configs.moonshot_v1_16b_a3b",
                "repro_torch.configs.llama4_maverick_400b_a17b",
                "repro_torch.configs.internvl2_26b",
                "repro_torch.configs.yi_9b", "repro_torch.configs.minitron_8b",
                "repro_torch.models.moe",
                "repro_torch.models.attention",
                "repro_torch.models.transformer", "repro_torch.models.api",
                "repro_torch.serve.engine",
                "repro_torch.kernels.flash_attention",
                "repro_torch.kernels.int8_matmul", "repro_torch.kernels.ops"]
        code = ("import importlib, sys\n"
                f"for m in {mods!r}:\n"
                "    importlib.import_module(m)\n"
                "bad = sorted(n for n in sys.modules if n.split('.')[0] in"
                " ('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
                "assert not bad, bad\n")
        env = dict(os.environ, PYTHONPATH=str(src))
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr


# ------------------------------------------------------------- on card --

@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_card_forward_matches_cpu(jax_params, ids, arch):
    """Both routes on the card against the CPU, fp32 smoke config: the
    flash route launches the kernel once per layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    params = jax_params(arch, "float32")
    for impl in ("xla", "flash"):
        _, tcfg = configs(arch, dtype="float32", attn_impl=impl)
        want, _ = TT.lm_forward(port(params), tcfg,
                                torch.from_numpy(ids).long())
        before = flash_attention_cuda.launches
        got, _ = TT.lm_forward(from_numpy_tree(np_tree(params), "cuda"),
                               tcfg, torch.from_numpy(ids).long().cuda())
        torch.cuda.synchronize()
        assert flash_attention_cuda.launches - before == (
            tcfg.n_layers if impl == "flash" else 0)
        assert_logits(got.cpu(), want.numpy())
