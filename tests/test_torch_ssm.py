"""Parity of the port's linear-scan engine, xLSTM and Hymba with ``repro``.

Both packages run the JAX smoke configs of ``xlstm-1.3b`` (4 layers in
two groups of one mLSTM and one sLSTM, d_model 64, 2 heads) and
``hymba-1.5b`` (2 layers, 4 query heads over 2 KV heads, window 16, SSM
state 8) on the same parameters (drawn by the JAX inits, carried across
through ``repro_torch.convert``) and the same inputs
(``np.random.default_rng``).  T = 24 is not a multiple of the 256-step
chunk, so every full-sequence pass runs the padded path.

Tolerances, as ``tests/test_torch_lm.py`` states them:

* float32: rtol 1e-4 and atol 1e-4 * max|value|; greedy ids are equal.
  The chunk scan's ``cumsum`` and its products may sum in another order
  than XLA's; that moves values by a few ulps, far inside 1e-4.
* bfloat16: atol 4e-2 * max|logit| (XLA fuses elementwise chains and
  rounds to bf16 once a fusion, where each op here rounds).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import hymba as JH
from repro.models import linear_scan as JS
from repro.models import xlstm as JX
from repro.models.api import get_model as jax_get_model
from repro.serve.engine import Engine as JaxEngine
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import from_numpy_tree
from repro_torch.models import hymba as TH
from repro_torch.models import linear_scan as TS
from repro_torch.models import xlstm as TX
from repro_torch.models.api import get_model
from repro_torch.serve.engine import Engine
from repro_torch.tree import leaves_with_paths

ARCHS = ["xlstm-1.3b", "hymba-1.5b"]
B, T = 2, 24
RTOL = 1e-4
BF16_ATOL = 4e-2

JAX_FNS = {
    "xlstm-1.3b": (JX.xlstm_init, JX.xlstm_forward, JX.xlstm_init_cache,
                   JX.xlstm_prefill, JX.xlstm_decode_step),
    "hymba-1.5b": (JH.hymba_init, JH.hymba_forward, JH.hymba_cache_init,
                   JH.hymba_prefill, JH.hymba_decode_step),
}
TORCH_FNS = {
    "xlstm-1.3b": (TX.xlstm_forward, TX.xlstm_init_cache, TX.xlstm_prefill,
                   TX.xlstm_decode_step),
    "hymba-1.5b": (TH.hymba_forward, TH.hymba_cache_init, TH.hymba_prefill,
                   TH.hymba_decode_step),
}
_jit = {}


def jitted(arch, i):
    """JAX's i-th function of ``arch`` (init, forward, init_cache,
    prefill, decode), jitted with the config static (init_cache, which
    takes shapes, as it is)."""
    if i == 2:
        return JAX_FNS[arch][2]
    if (arch, i) not in _jit:
        _jit[arch, i] = jax.jit(JAX_FNS[arch][i], static_argnums=1)
    return _jit[arch, i]


def configs(arch, **over):
    return (jax_smoke(arch).replace(**over),
            get_smoke_config(arch).replace(**over))


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
def ids():
    return np.random.default_rng(0).integers(0, 512, (B, T)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_params():
    """JAX smoke params per (arch, dtype), drawn once."""
    cache = {}

    def get(arch, dtype):
        if (arch, dtype) not in cache:
            jcfg = jax_smoke(arch).replace(dtype=dtype)
            cache[arch, dtype] = jitted(arch, 0)(jax.random.PRNGKey(1),
                                                 jcfg)
        return cache[arch, dtype]
    return get


# --------------------------------------------------------- linear scan --

def scan_inputs(t, dtype=np.float32, seed=2, h=3, dk=8, dv=12):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((2, h, t, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((2, h, t, dv)).astype(np.float32)
    f = rng.uniform(0.5, 0.999, (2, h, t)).astype(np.float32)
    i = rng.uniform(0.05, 1.0, (2, h, t)).astype(np.float32)
    jx = [jnp.asarray(a).astype(dtype) for a in (q, k, v)] + [
        jnp.log(jnp.asarray(f)), jnp.asarray(i)]
    tx = [torch.from_numpy(a).to(getattr(torch, jnp.dtype(dtype).name))
          for a in (q, k, v)] + [torch.log(torch.from_numpy(f)),
                                 torch.from_numpy(i)]
    return jx, tx


class TestLinearScan:
    @pytest.mark.parametrize("normalize", [True, False])
    def test_chunked_scan_matches_jax_and_reference(self, normalize):
        """T 48 in chunks of 16: the chunk products and the carried f32
        state against JAX's, and against the O(T) recurrence."""
        jx, tx = scan_inputs(48)
        want = JS.chunked_scan(*jx, chunk=16, normalize=normalize)
        got = TS.chunked_scan(*tx, chunk=16, normalize=normalize)
        close(got, want)
        ref = TS.reference_scan(*tx, normalize=normalize)
        close(got, ref.numpy())
        close(ref, JS.reference_scan(*jx, normalize=normalize))

    @pytest.mark.parametrize("normalize", [True, False])
    def test_padded_length(self, normalize):
        """T = 40, not a multiple of the chunk: padded to 256 as the blocks
        pad (log f = 0, gate 0), the first 40 steps equal the recurrence."""
        _, tx = scan_inputs(40, seed=3)
        q, k, v, lf, ig = TX._pad_time(*tx)
        assert q.shape[2] == 256 and lf.shape[2] == 256
        got = TS.chunked_scan(q, k, v, lf, ig, normalize=normalize)
        close(got[:, :, :40], TS.reference_scan(*tx, normalize=normalize)
              .numpy())

    def test_bf16_operands_promote_to_f32(self):
        """bf16 q, k, v against f32 gates: JAX promotes the mixed
        products to f32; the port casts up the same way."""
        jx, tx = scan_inputs(32, dtype=jnp.bfloat16, seed=4)
        want = JS.chunked_scan(*jx, chunk=16)
        got = TS.chunked_scan(*tx, chunk=16)
        assert got.dtype == torch.bfloat16
        close(got, want, "bfloat16")

    @pytest.mark.parametrize("normalize", [True, False])
    def test_recurrent_step(self, normalize):
        rng = np.random.default_rng(5)
        arrs = [rng.standard_normal(s).astype(np.float32) for s in
                ((2, 3, 8, 12), (2, 3, 8), (2, 3, 8), (2, 3, 8),
                 (2, 3, 12))]
        f, i = (rng.uniform(0.1, 1.0, (2, 3)).astype(np.float32)
                for _ in range(2))
        (js, jn), jh = JS.recurrent_step(
            (jnp.asarray(arrs[0]), jnp.asarray(arrs[1])),
            *(jnp.asarray(a) for a in arrs[2:]), jnp.asarray(f),
            jnp.asarray(i), normalize)
        (ts, tn), th = TS.recurrent_step(
            (torch.from_numpy(arrs[0]), torch.from_numpy(arrs[1])),
            *(torch.from_numpy(a) for a in arrs[2:]), torch.from_numpy(f),
            torch.from_numpy(i), normalize)
        for got, want in ((ts, js), (tn, jn), (th, jh)):
            close(got, want, rtol=1e-5)


# --------------------------------------------------------------- xLSTM --

class TestXLSTMParts:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("with_state", [False, True])
    def test_causal_conv(self, dtype, with_state):
        rng = np.random.default_rng(6)
        x = rng.standard_normal((2, 7, 10)).astype(np.float32)
        w = rng.standard_normal((4, 10)).astype(np.float32)
        st = rng.standard_normal((2, 3, 10)).astype(np.float32)
        jd, td = jnp.dtype(dtype), getattr(torch, dtype)
        jout, jst = JX._causal_conv(
            jnp.asarray(x, jd), jnp.asarray(w, jd),
            jnp.asarray(st, jd) if with_state else None)
        tout, tst = TX._causal_conv(
            torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
            torch.from_numpy(st).to(td) if with_state else None)
        assert tout.dtype == td and tst.shape == (2, 3, 10)
        assert np.array_equal(tst.float().numpy(),
                              np.asarray(jst.astype(jnp.float32)))
        close(tout, jout, dtype, rtol=1e-5)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_slstm_cell(self, jax_params, dtype):
        jcfg, tcfg = configs("xlstm-1.3b", dtype=dtype)
        sp = jax.tree_util.tree_map(lambda a: a[0],
                                    jax_params("xlstm-1.3b", dtype)
                                    ["sblocks"])
        rng = np.random.default_rng(7)
        xt = rng.standard_normal((B, 4 * 64)).astype(np.float32)
        st = {k: rng.uniform(0.1, 1.0, (B, 64)).astype(np.float32)
              for k in ("c", "n", "h")}
        jst, jh = JX._slstm_cell(sp, jcfg, jnp.asarray(xt, jcfg.dtype),
                                 {k: jnp.asarray(v) for k, v in st.items()})
        tst, th = TX._slstm_cell(port(sp), tcfg, torch.from_numpy(xt).to(
            getattr(torch, dtype)), {k: torch.from_numpy(v)
                                     for k, v in st.items()})
        assert th.dtype == torch.float32
        for k in ("c", "n", "h"):
            close(tst[k], jst[k], dtype if k == "h" else "float32",
                  rtol=1e-5)

    def test_group_layout_and_tree(self, jax_params):
        """Nested [groups, mLSTM per group] stacking: the port's init
        draws JAX's tree, leaf for leaf in shape and dtype."""
        _, tcfg = configs("xlstm-1.3b")
        assert TX.group_layout(tcfg) == (2, 1)
        assert TX.group_layout(get_config("xlstm-1.3b")) == (6, 7)
        want = np_tree(jax_params("xlstm-1.3b", "bfloat16"))
        got = TX.xlstm_init(torch.Generator().manual_seed(0), tcfg)
        wl = jax.tree_util.tree_flatten_with_path(want)[0]
        gl = list(leaves_with_paths(got))
        assert [tuple(p.key for p in path) for path, _ in wl] == [
            p for p, _ in gl]
        for (_, w), (_, g) in zip(wl, gl):
            assert tuple(g.shape) == w.shape
            assert str(g.dtype)[6:] == w.dtype.name
        assert torch.all(got["mblocks"]["wgate"]["b"][..., 2:] == 3.0)


# ---------------------------------------------------------- both archs --

def jax_steps(arch, jcfg, params, ids, n_decode, max_len):
    cache = jitted(arch, 2)(jcfg, ids.shape[0], max_len)
    logits, cache = jitted(arch, 3)(params, jcfg, jnp.asarray(ids), cache)
    pre, steps, toks = np.asarray(logits), [], []
    for i in range(n_decode):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks.append(np.array(tok))
        logits, cache = jitted(arch, 4)(params, jcfg, tok,
                                        jnp.asarray(ids.shape[1] + i), cache)
        steps.append(np.asarray(logits))
    return pre, steps, toks, cache


def check_steps(arch, jcfg, tcfg, params, ids, n_decode, dtype="float32",
                max_len=None):
    """The port's prefill and decode steps, fed JAX's tokens, against
    JAX's logits at every step; returns both final caches."""
    max_len = max_len or ids.shape[1] + n_decode
    want_pre, want_steps, toks, jcache = jax_steps(arch, jcfg, params, ids,
                                                   n_decode, max_len)
    _, init_cache, prefill, decode = TORCH_FNS[arch]
    tp = port(params)
    cache = init_cache(tcfg, ids.shape[0], max_len)
    got, cache = prefill(tp, tcfg, torch.from_numpy(ids).long(), cache)
    close(got, want_pre, dtype)
    for i, (tok, want) in enumerate(zip(toks, want_steps)):
        got, cache = decode(tp, tcfg, torch.from_numpy(tok).long(),
                            ids.shape[1] + i, cache)
        close(got, want, dtype)
    return cache, jcache


class TestArchs:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_configs_mirror_jax(self, arch):
        for t_fn, j_fn in ((get_config, jax_config),
                           (get_smoke_config, jax_smoke)):
            tc = dataclasses.asdict(t_fn(arch))
            jc = dataclasses.asdict(j_fn(arch))
            tc.pop("quant"), jc.pop("quant")
            assert tc == jc

    @pytest.mark.parametrize("arch,impl", [("xlstm-1.3b", "xla"),
                                           ("hymba-1.5b", "xla"),
                                           ("hymba-1.5b", "flash")])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_forward_matches_jax(self, jax_params, ids, arch, impl, dtype):
        """Hymba's flash route runs JAX's Pallas kernel in interpret mode
        and the port's plain version, both with the window."""
        jcfg, tcfg = configs(arch, dtype=dtype, attn_impl=impl)
        params = jax_params(arch, dtype)
        want, _ = jitted(arch, 1)(params, jcfg, jnp.asarray(ids))
        got, aux = get_model(tcfg).forward(port(params),
                                           torch.from_numpy(ids).long())
        assert got.dtype == torch.float32 and got.shape == (B, T, 512)
        assert aux.item() == 0.0
        close(got, want, dtype)

    @pytest.mark.parametrize("arch", ARCHS)
    def test_prefill_and_decode_match_jax(self, jax_params, ids, arch):
        """Prefill, then 4 decode steps; every cache leaf after them
        matches JAX's."""
        jcfg, tcfg = configs(arch, dtype="float32")
        cache, jcache = check_steps(arch, jcfg, tcfg,
                                    jax_params(arch, "float32"), ids, 4)
        jl = jax.tree_util.tree_flatten_with_path(np_tree(jcache))[0]
        tl = dict(leaves_with_paths(cache))
        assert len(jl) == len(tl)
        for path, want in jl:
            got = tl[tuple(p.key for p in path)]
            assert tuple(got.shape) == want.shape
            close(got, want.astype(np.float32))

    @pytest.mark.parametrize("arch", ARCHS)
    def test_bf16_steps_within_bound(self, jax_params, ids, arch):
        jcfg, tcfg = configs(arch, dtype="bfloat16")
        check_steps(arch, jcfg, tcfg, jax_params(arch, "bfloat16"), ids, 2,
                    dtype="bfloat16")

    def test_hymba_rolling_cache_past_the_window(self, jax_params, ids):
        """Window 16: the 24-token prompt already overruns it, and 10
        decode steps wrap the rolling slots again; the cache is 16 slots
        whatever max_len."""
        jcfg, tcfg = configs("hymba-1.5b", dtype="float32")
        cache = TH.hymba_cache_init(tcfg, B, 100)
        assert cache["attn"]["k"].shape == (2, B, 16, 2, 16)
        check_steps("hymba-1.5b", jcfg, tcfg,
                    jax_params("hymba-1.5b", "float32"), ids, 10,
                    max_len=100)

    @pytest.mark.parametrize("arch", ARCHS)
    def test_loss_fn_matches_jax(self, jax_params, ids, arch):
        jcfg, tcfg = configs(arch, dtype="float32")
        params = jax_params(arch, "float32")
        labels = np.roll(ids, -1, axis=1)
        want, wm = jax_get_model(jcfg).loss_fn(
            params, {"tokens": jnp.asarray(ids),
                     "labels": jnp.asarray(labels)})
        got, m = get_model(tcfg).loss_fn(
            port(params), {"tokens": torch.from_numpy(ids).long(),
                           "labels": torch.from_numpy(labels).long()})
        assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
        assert set(m) == set(wm) == {"loss", "ce", "moe_aux"}

    @pytest.mark.parametrize("arch", ARCHS)
    def test_greedy_ids_equal_jax_engine(self, jax_params, ids, arch):
        """Engine.generate on both packages: the same greedy ids.  The
        max_len (20) is shorter than prompt plus steps: xLSTM's state and
        Hymba's rolling cache hold no positions, so both generate past
        it, as JAX's engine does."""
        jcfg, tcfg = configs(arch, dtype="float32")
        params = jax_params(arch, "float32")
        n_gen = 6
        want = JaxEngine(jax_get_model(jcfg), params, max_len=20,
                         batch_size=B).generate(
            {"tokens": jnp.asarray(ids)}, n_gen)
        got = Engine(get_model(tcfg), port(params), max_len=20,
                     batch_size=B, device="cpu").generate(
            {"tokens": torch.from_numpy(ids).long()}, n_gen)
        assert np.array_equal(got["ids"].numpy(), np.asarray(want["ids"]))

    @pytest.mark.parametrize("arch", ARCHS)
    def test_last_logits_match_forward(self, jax_params, ids, arch):
        """The last decode step's logits equal the forward's on the prompt
        extended by the generated ids, and their argmax is the same (what
        the card's smoke checks)."""
        _, tcfg = configs(arch, dtype="float32")
        api = get_model(tcfg)
        tp = port(jax_params(arch, "float32"))
        prompt = torch.from_numpy(ids).long()
        out = Engine(api, tp, max_len=T + 5, batch_size=B,
                     device="cpu").generate({"tokens": prompt}, 5)
        want, _ = api.forward(tp, torch.cat([prompt, out["ids"]], dim=1))
        close(out["logits"], want[:, -1].numpy())
        assert torch.equal(out["logits"].argmax(-1), want[:, -1].argmax(-1))
