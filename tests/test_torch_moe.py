"""Parity of the port's MoE layer, ``xla_chunked`` attention and the
decoder configs (moonshot, llama4-maverick, internvl2, yi-9b,
minitron-8b) with ``repro``.

Both packages run the JAX smoke configs on the same parameters (drawn by
the JAX inits and carried across through ``repro_torch.convert``) and
the same inputs (``np.random.default_rng``).

Tolerances, as ``tests/test_torch_lm.py`` states them:

* float32: rtol 1e-4 and atol 1e-4 * max|logit|; greedy ids are equal.
* bfloat16: atol 4e-2 * max|logit|.  The MoE layer alone is bitwise
  JAX's in bf16 (``test_moe_apply_matches_jax``).  A whole bf16 MoE
  forward is held against JAX run op by op (``jax.disable_jit``): under
  ``jit`` XLA's CPU fusions round hidden values once per fusion, a bf16
  step away from the eager ops here and there, and at smoke width (d 64,
  8 experts) that flips near-tied top-k choices, each moving a token's
  output by a whole expert (moonshot: 0.30 of max|logit|).

Routing: a top-k choice that differs between the packages is accepted
only where the k-th and (k+1)-th router probabilities of that token
differ by less than ``ROUTE_GAP``, and every such flip is printed (the
rule kNN boundary swaps follow); a flipped token is left out of the
output comparison, which the print reports.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import attention as JA
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.api import get_model as jax_get_model
from repro.serve.engine import Engine as JaxEngine
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.convert import from_numpy_tree
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.models.api import get_model
from repro_torch.serve.engine import Engine
from repro_torch.tree import leaves_with_paths

MOE = ["moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b"]
ARCHS = MOE + ["internvl2-26b", "yi-9b", "minitron-8b"]
B, T = 2, 16
RTOL = 1e-4
BF16_ATOL = 4e-2
ROUTE_GAP = 1e-5

jax_init = jax.jit(JT.lm_init, static_argnums=1)
jax_forward = jax.jit(JT.lm_forward, static_argnums=1)
jax_prefill = jax.jit(JT.lm_prefill, static_argnums=1)
jax_decode = jax.jit(JT.lm_decode_step, static_argnums=1)
jax_moe = jax.jit(JM.moe_apply, static_argnums=1)


def configs(arch, **over):
    return (jax_smoke(arch).replace(**over),
            get_smoke_config(arch).replace(**over))


def port(tree):
    return from_numpy_tree(jax.tree_util.tree_map(np.asarray, tree))


def assert_logits(got, want, dtype="float32"):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL * scale)


def stub(cfg, b, t, seed=5):
    """The VLM patch stub's inputs: float [B, T, d] embeddings."""
    return np.random.default_rng(seed).standard_normal(
        (b, t, cfg.d_model)).astype(np.float32)


def inputs(cfg, ids):
    """Token ids, or stub embeddings for the VLM."""
    if cfg.frontend == "patch_stub":
        return stub(cfg, *ids.shape)
    return ids


def to_torch(x):
    x = torch.from_numpy(np.array(x))
    return x if x.is_floating_point() else x.long()


@pytest.fixture(scope="module")
def ids():
    return np.random.default_rng(0).integers(0, 512, (B, T)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_params():
    """JAX smoke params per (arch, dtype), drawn once."""
    cache = {}

    def get(arch, dtype):
        if (arch, dtype) not in cache:
            cache[arch, dtype] = jax_init(jax.random.PRNGKey(0),
                                          jax_smoke(arch).replace(dtype=dtype))
        return cache[arch, dtype]
    return get


# ------------------------------------------------------------ configs --

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_mirror_jax(arch):
    """Full and smoke configs equal JAX's in every field the port has."""
    for t_fn, j_fn in ((get_config, jax_config), (get_smoke_config,
                                                  jax_smoke)):
        tc, jc = dataclasses.asdict(t_fn(arch)), dataclasses.asdict(
            j_fn(arch))
        tc.pop("quant")
        assert tc == {n: jc[n] for n in tc}
    assert arch in list_archs()


def test_param_counts_match_jax(jax_params):
    for arch in MOE:
        _, tcfg = configs(arch)
        params = jax_params(arch, "float32")
        tp = port(params)
        assert TT.param_count(tp) == JT.param_count(params)
        assert TT.active_param_count(tp, tcfg) == JT.active_param_count(
            params, jax_smoke(arch))
    assert TT.active_param_count(port(jax_params("yi-9b", "float32")),
                                 get_smoke_config("yi-9b")) == \
        JT.param_count(jax_params("yi-9b", "float32"))


@pytest.mark.parametrize("arch", MOE)
def test_full_size_tree_matches_jax(monkeypatch, arch):
    """The full-width tree, drawn on the meta device (shapes only): every
    leaf's shape and dtype equal ``jax.eval_shape``'s, and so do the
    parameter counts (moonshot: 28,057,995,264, which ``chip_smoke.py``
    checks on the card)."""
    jcfg = jax_config(arch)
    shapes = jax.eval_shape(lambda k: JT.lm_init(k, jcfg),
                            jax.random.PRNGKey(0))
    monkeypatch.setattr(TL, "_normal", lambda gen, shape, std: torch.empty(
        shape, device="meta"))
    cfg = get_config(arch)
    tree = TT.lm_init(torch.Generator().manual_seed(0), cfg)
    want = {tuple(k.key for k in path): (tuple(x.shape), str(x.dtype))
            for path, x in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {path: (tuple(t.shape), str(t.dtype)[6:])
           for path, t in leaves_with_paths(tree)}
    assert got == want
    total = TT.param_count(tree)
    assert total == sum(int(np.prod(s)) for s, _ in want.values())
    if arch == "moonshot-v1-16b-a3b":
        assert total == 28_057_995_264
    frac = cfg.experts_per_token / cfg.n_experts
    assert TT.active_param_count(tree, cfg) == sum(
        int(np.prod(s) * frac) if path[-1] in ("gate_w", "up_w", "down_w")
        else int(np.prod(s)) for path, (s, _) in want.items())


# ---------------------------------------------------------- the layer --

def route_flips(want_e, got_e, probs, k):
    """Rows whose top-k expert sets differ; each must be a near tie
    (k-th minus (k+1)-th probability below ROUTE_GAP).  Printed."""
    differ = np.any(np.sort(want_e, -1) != np.sort(got_e, -1), axis=-1)
    srt = -np.sort(-probs, axis=-1)
    gaps = srt[:, k - 1] - (srt[:, k] if probs.shape[1] > k else 0.0)
    for row in np.nonzero(differ)[0]:
        print(f"routing flip at token {row}: gap {gaps[row]:.3g}")
        assert gaps[row] < ROUTE_GAP, (row, gaps[row])
    return differ


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_matches_jax(arch, dtype):
    """y, aux and the routing of one layer at the same inputs; bf16 and
    f32 both bitwise-close (no flip expected at these draws)."""
    jcfg, tcfg = configs(arch, dtype=dtype)
    p = JM.moe_init(jax.random.PRNGKey(1), jcfg)
    xj = jnp.asarray(stub(jcfg, 2, 24, seed=3)).astype(jcfg.dtype)
    y, aux = jax_moe(p, jcfg, xj)
    xf = xj.reshape(-1, jcfg.d_model).astype(jnp.float32)
    probs = jax.nn.softmax(xf @ p["router"]["w"], axis=-1)
    _, want_e = jax.lax.top_k(probs, jcfg.experts_per_token)

    tp = port(p)
    xt = port(np.asarray(xj))
    got_y, got_aux = TM.moe_apply(tp, tcfg, xt)
    _, _, got_e = TM.route(tp, tcfg, xt.reshape(-1, tcfg.d_model))
    flips = route_flips(np.asarray(want_e), got_e.numpy(), np.asarray(probs),
                        tcfg.experts_per_token)
    assert got_y.dtype == xt.dtype and got_y.shape == xt.shape
    np.testing.assert_allclose(got_aux.item(), float(aux), rtol=1e-4)
    want_y = np.asarray(y.astype(jnp.float32)).reshape(-1, tcfg.d_model)
    got_y = got_y.float().numpy().reshape(-1, tcfg.d_model)
    if flips.any():
        print(f"{int(flips.sum())} flipped tokens left out of y")
    keep = ~flips
    if dtype == "bfloat16":
        assert np.array_equal(got_y[keep], want_y[keep])
    else:
        np.testing.assert_allclose(got_y[keep], want_y[keep], rtol=1e-5,
                                   atol=1e-5 * np.abs(want_y).max())


def test_capacity_formula_matches_jax():
    for arch in ("moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b"):
        for cf in (1e-9, 1.0, 1.25, 64 / 6):
            jc = jax_config(arch).replace(capacity_factor=cf)
            tc = get_config(arch).replace(capacity_factor=cf)
            for n in (1, 4, 7, 256, 2048, 8192):
                assert TM.capacity(tc, n) == JM.capacity(jc, n)
                assert TM.capacity(tc, n) % 8 == 0
    full = get_config("moonshot-v1-16b-a3b")
    assert [TM.capacity(full, n) for n in (4, 256, 2048, 8192)] == [
        8, 32, 240, 960]


def moe_setup(e=8, k=2, cf=2.0, seed=0):
    cfg = get_smoke_config("moonshot-v1-16b-a3b").replace(
        n_experts=e, experts_per_token=k, capacity_factor=cf,
        dtype="float32")
    return cfg, TM.moe_init(torch.Generator().manual_seed(seed), cfg)


class TestInvariants:
    """``tests/test_moe.py``'s invariants, on the port."""

    def test_identical_experts_conserve_mass(self):
        """Identical experts and no drop: the output is the one expert's
        SwiGLU, whatever the routing (the weights sum to one)."""
        cfg, p = moe_setup(e=8, k=4, cf=16.0)
        for name in ("gate_w", "up_w", "down_w"):
            p[name] = p[name][:1].repeat(8, 1, 1)
        x = torch.randn(2, 8, cfg.d_model,
                        generator=torch.Generator().manual_seed(1))
        y, _ = TM.moe_apply(p, cfg, x)
        ref = TL.swiglu_apply({"gate": {"w": p["gate_w"][0]},
                               "up": {"w": p["up_w"][0]},
                               "down": {"w": p["down_w"][0]}}, x)
        torch.testing.assert_close(y, ref, rtol=1e-4, atol=1e-4)

    def test_combine_weights_sum_to_one(self):
        cfg, p = moe_setup(e=8, k=4)
        x = torch.randn(32, cfg.d_model,
                        generator=torch.Generator().manual_seed(2))
        probs, top_p, top_e = TM.route(p, cfg, x)
        torch.testing.assert_close(top_p.sum(-1), torch.ones(32))
        srt = torch.sort(probs, -1, descending=True).values
        assert torch.equal(torch.gather(probs, 1, top_e), srt[:, :4])

    def test_dispatch_places_every_kept_entry(self):
        """Every kept entry's token sits in its expert's slot, in token
        order; unused slots are zero; counts add up to N * k."""
        cfg, p = moe_setup(e=8, k=2, cf=1.0)
        x = torch.randn(40, cfg.d_model,
                        generator=torch.Generator().manual_seed(3))
        _, _, top_e = TM.route(p, cfg, x)
        c = TM.capacity(cfg, 40)
        d = TM.dispatch(cfg, x, top_e, c)
        assert int(d.counts.sum()) == 80
        flat = d.hb.reshape(-1, cfg.d_model)
        kept = d.dest[d.keep]
        assert torch.equal(flat[kept], x[d.order[d.keep] // 2])
        unused = torch.ones(8 * c, dtype=torch.bool)
        unused[kept] = False
        assert not flat[unused].any()
        for e in range(8):
            toks = (d.order // 2)[(d.dest // c == e) & d.keep]
            assert torch.equal(toks, toks.sort().values)

    def test_capacity_drops_the_last_tokens(self):
        """All tokens route first to expert 0: its first ``c`` tokens are
        kept, the rest dropped, and a dropped entry adds nothing."""
        cfg, p = moe_setup(e=8, k=2, cf=1e-9)
        p["router"]["w"] = torch.zeros_like(p["router"]["w"])
        p["router"]["w"][:, 0] = 100.0
        x = torch.randn(4, 64, cfg.d_model,
                        generator=torch.Generator().manual_seed(4)).abs()
        c = TM.capacity(cfg, 256)
        assert c == 8
        xf = x.reshape(256, -1)
        _, top_p, top_e = TM.route(p, cfg, xf)
        assert bool((top_e[:, 0] == 0).all())
        d = TM.dispatch(cfg, xf, top_e, c)
        kept0 = (d.order // 2)[d.keep & (d.dest < c)]
        assert kept0.tolist() == list(range(8))
        y, _ = TM.moe_apply(p, cfg, x)
        assert float(y.abs().mean()) < float(x.abs().mean())

    def test_deterministic_and_ordered_bf16_combine(self):
        """Two runs are bitwise equal, and the bf16 combine is the sum of
        each token's weighted outputs added from zero in ascending expert
        order, one rounding per add."""
        cfg, p = moe_setup(e=8, k=3, cf=4.0)
        cfg = cfg.replace(dtype="bfloat16")
        p = {k: (v if k == "router" else v.to(torch.bfloat16))
             for k, v in p.items()}
        x = torch.randn(2, 12, cfg.d_model,
                        generator=torch.Generator().manual_seed(5)
                        ).to(torch.bfloat16)
        y1, a1 = TM.moe_apply(p, cfg, x)
        y2, a2 = TM.moe_apply(p, cfg, x)
        assert torch.equal(y1, y2) and torch.equal(a1, a2)
        xf = x.reshape(24, -1)
        _, top_p, top_e = TM.route(p, cfg, xf)
        c = TM.capacity(cfg, 24)
        d = TM.dispatch(cfg, xf, top_e, c)
        yb = TM.experts(p, d.hb).reshape(8 * c, -1)
        # JAX's scatter-add, entry by entry in sorted (expert) order
        want = torch.zeros_like(xf)
        for s in range(24 * 3):
            tok, slot = divmod(int(d.order[s]), 3)
            if d.keep[s]:
                w = top_p[tok, slot].to(torch.bfloat16)
                want[tok] = want[tok] + yb[d.dest[s]] * w
        assert torch.equal(y1.reshape(24, -1), want)

    def test_top_k_ties_go_to_the_lower_index(self):
        probs = torch.tensor([[0.2, 0.3, 0.3, 0.2], [0.25] * 4,
                              [0.1, 0.4, 0.1, 0.4]])
        got_p, got_e = TM.top_k(probs, 2)
        want_p, want_e = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
        assert got_e.tolist() == np.asarray(want_e).tolist()
        assert np.array_equal(got_p.numpy(), np.asarray(want_p))

    def test_no_host_sync_in_a_forward(self, monkeypatch):
        """The ops that read a device tensor back to the host (or size a
        result by the data) are never called in an MoE forward."""
        cfg, tcfg = configs("moonshot-v1-16b-a3b", dtype="float32")
        params = TT.lm_init(torch.Generator().manual_seed(0), tcfg)
        x = torch.from_numpy(np.random.default_rng(1).integers(
            0, 512, (B, T)))

        def refuse(*a, **kw):
            raise AssertionError("host sync")
        for obj, name in ((torch.Tensor, "item"), (torch.Tensor, "tolist"),
                          (torch.Tensor, "nonzero"), (torch, "nonzero"),
                          (torch.Tensor, "cpu"), (torch, "bincount"),
                          (torch.nn.functional, "one_hot"),
                          (torch, "masked_select"), (torch, "unique")):
            monkeypatch.setattr(obj, name, refuse)
        logits, aux = TT.lm_forward(params, tcfg, x)
        monkeypatch.undo()
        assert logits.shape == (B, T, 512) and aux.item() > 0


# -------------------------------------------------------- xla_chunked --

@pytest.mark.parametrize("causal,window,q_offset", [(True, 0, 0),
                                                    (True, 5, 0),
                                                    (False, 0, 0),
                                                    (True, 0, 3)])
def test_xla_chunked_matches_jax(causal, window, q_offset):
    """T = 21 keys in chunks of 8 (the last padded and masked), GQA 4/2."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 21, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 21, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 21, 2, 16)).astype(np.float32)
    want = JA._sdpa_xla_chunked(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal, window, q_offset,
                                chunk=8)
    got = TA._sdpa_xla_chunked(*map(torch.from_numpy, (q, k, v)), causal,
                               window, q_offset, chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    dense = TA._sdpa_xla(*map(torch.from_numpy, (q, k, v)), causal, window,
                         q_offset)
    torch.testing.assert_close(got, dense, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ forward --

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_f32_matches_jax(jax_params, ids, arch):
    """Logits and the aux loss (summed over layers); internvl2 on stub
    embeddings."""
    jcfg, tcfg = configs(arch, dtype="float32")
    params = jax_params(arch, "float32")
    x = inputs(jcfg, ids)
    want, want_aux = jax_forward(params, jcfg, jnp.asarray(x))
    got, aux = get_model(tcfg).forward(port(params), to_torch(x))
    assert got.dtype == torch.float32 and got.shape == (B, T, 512)
    assert_logits(got, want)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-4)
    assert (aux.item() > 0) == (tcfg.n_experts > 0)


@pytest.mark.parametrize("impl", ["flash", "xla_chunked"])
def test_moe_forward_routes_match_jax(jax_params, ids, impl):
    """The flash route (its plain version on the CPU) and the chunked
    route against JAX's xla logits (the same function)."""
    jcfg, tcfg = configs("moonshot-v1-16b-a3b", dtype="float32")
    params = jax_params("moonshot-v1-16b-a3b", "float32")
    want, _ = jax_forward(params, jcfg, jnp.asarray(ids))
    got, _ = TT.lm_forward(port(params), tcfg, to_torch(ids), impl=impl)
    assert_logits(got, want)


def test_moe_forward_bf16_matches_eager_jax(jax_params, ids):
    """moonshot in bf16 (maverick's layer is held bitwise above)."""
    arch = "moonshot-v1-16b-a3b"
    jcfg, tcfg = configs(arch, dtype="bfloat16")
    params = jax_params(arch, "bfloat16")
    with jax.disable_jit():
        want, want_aux = JT.lm_forward(params, jcfg, jnp.asarray(ids))
    got, aux = TT.lm_forward(port(params), tcfg, to_torch(ids))
    assert_logits(got, want, "bfloat16")
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-4)


# -------------------------------------------------------- serve steps --

@pytest.mark.parametrize("arch", ARCHS)
def test_steps_and_greedy_ids_match_jax(jax_params, ids, arch):
    """JAX's prefill and greedy decode loop (what its ``Engine.generate``
    runs) against the port's steps, fed JAX's tokens, and the port's
    ``Engine.generate`` ids against JAX's greedy tokens."""
    jcfg, tcfg = configs(arch, dtype="float32")
    params = jax_params(arch, "float32")
    prompt = inputs(jcfg, ids[:, :10])
    n_gen = 3
    cache = JT.lm_init_cache(jcfg, B, 10 + n_gen)
    logits, cache = jax_prefill(params, jcfg, jnp.asarray(prompt), cache)
    want_steps, toks = [np.asarray(logits)], []
    for i in range(n_gen):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        logits, cache = jax_decode(params, jcfg, tok, jnp.asarray(10 + i),
                                   cache)
        want_steps.append(np.asarray(logits))

    tp = port(params)
    tcache = TT.lm_init_cache(tcfg, B, 10 + n_gen)
    got, tcache = TT.lm_prefill(tp, tcfg, to_torch(prompt), tcache)
    assert_logits(got, want_steps[0])
    for i, tok in enumerate(toks):
        got, tcache = TT.lm_decode_step(tp, tcfg, to_torch(tok), 10 + i,
                                        tcache)
        assert_logits(got, want_steps[i + 1])
    out = Engine(get_model(tcfg), tp, max_len=10 + n_gen, batch_size=B,
                 device="cpu").generate({"tokens": to_torch(prompt)}, n_gen)
    assert np.array_equal(out["ids"].numpy(), np.stack(toks, axis=1))


def test_engine_ids_equal_jax_engine(jax_params, ids):
    jcfg, tcfg = configs("moonshot-v1-16b-a3b", dtype="float32")
    params = jax_params("moonshot-v1-16b-a3b", "float32")
    want = JaxEngine(jax_get_model(jcfg), params, max_len=T + 4,
                     batch_size=B).generate({"tokens": jnp.asarray(ids)}, 4)
    got = Engine(get_model(tcfg), port(params), max_len=T + 4, batch_size=B,
                 device="cpu").generate({"tokens": to_torch(ids)}, 4)
    assert np.array_equal(got["ids"].numpy(), np.asarray(want["ids"]))


def test_last_logits_match_forward_without_drops(jax_params, ids):
    """What the card's smoke checks: under ``capacity_factor = E / k``
    (capacity >= the tokens of a call, so nothing drops) the last decode
    logits equal the forward's over the prompt and the generated ids."""
    _, tcfg = configs("moonshot-v1-16b-a3b", dtype="float32")
    tcfg = tcfg.replace(capacity_factor=tcfg.n_experts
                        / tcfg.experts_per_token, attn_impl="flash")
    assert TM.capacity(tcfg, B * (T + 4)) >= B * (T + 4)
    api = get_model(tcfg)
    tp = port(jax_params("moonshot-v1-16b-a3b", "float32"))
    out = Engine(api, tp, max_len=T + 4, batch_size=B, device="cpu"
                 ).generate({"tokens": to_torch(ids)}, 4)
    want, _ = api.forward(tp, torch.cat([to_torch(ids), out["ids"]], 1))
    assert_logits(out["logits"], want[:, -1].numpy())


# ------------------------------------------------------------- on card --

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_card_moe_layer_matches_cpu(dtype):
    """The MoE layer on the card against the CPU: the routing identical
    but for near ties (reported), outputs within 1e-5 (f32) or a bf16
    step (2**-7 of the largest) elsewhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    _, tcfg = configs("moonshot-v1-16b-a3b", dtype=dtype)
    p = TM.moe_init(torch.Generator().manual_seed(1), tcfg)
    x = torch.from_numpy(stub(tcfg, 4, 64, seed=9)).to(getattr(torch, dtype))
    with TL.f32_sums():
        want, want_aux = TM.moe_apply(p, tcfg, x)
        probs, _, want_e = TM.route(p, tcfg, x.reshape(-1, tcfg.d_model))
        pc = {k: (v.cuda() if torch.is_tensor(v) else
                  {"w": v["w"].cuda()}) for k, v in p.items()}
        got, aux = TM.moe_apply(pc, tcfg, x.cuda())
        _, _, got_e = TM.route(pc, tcfg, x.cuda().reshape(-1, tcfg.d_model))
    flips = route_flips(want_e.numpy(), got_e.cpu().numpy(), probs.numpy(),
                        tcfg.experts_per_token)
    np.testing.assert_allclose(aux.item(), want_aux.item(), rtol=1e-5)
    g = got.float().cpu().reshape(-1, tcfg.d_model)[~torch.from_numpy(flips)]
    w = want.float().reshape(-1, tcfg.d_model)[~torch.from_numpy(flips)]
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    torch.testing.assert_close(g, w, rtol=tol, atol=tol * w.abs().max())
