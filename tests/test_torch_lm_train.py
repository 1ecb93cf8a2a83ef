"""Parity of the port's LM training slice with ``repro``: ``lm_loss``,
``ModelAPI.loss_fn``, remat, ``data/lm_data.py``, ``launch/{steps,train}.py``
and bf16 checkpoints.

Both packages run the JAX smoke configs (2 layers, d_model 64) of
tinyllama-1.1b, llama3.2-1b (tied embeddings), moonshot-v1-16b-a3b (MoE,
8 experts top-2; the loss includes 0.01 times the aux loss) and
internvl2-26b (float [B, T, d] stub embeddings) on the same parameters
(drawn by the JAX ``lm_init`` and carried across by ``convert``) and the
same inputs (``np.random.default_rng``).  JAX's loss and gradients are
``jax.value_and_grad(api.loss_fn, has_aux=True)``, jitted, at the smoke
configs' ``remat`` (off); the port's go through
``train.train_loop.value_and_grad`` with ``remat`` on and off.  A
moonshot variant at capacity factor 0.5 drops entries.

Tolerances:

* float32: each gradient leaf within 1e-5 of its own max|g|, the loss
  and its parts within rtol 1e-6.  Measured: at most 1.4e-6 (float32
  sums taken in another order, XLA's against PyTorch's).
* bfloat16: each leaf within 6e-2 of its own max|g|, the loss within
  rtol 2e-3.  Measured: at most 2.6e-2 (an RMSNorm scale) and 3e-4.
  XLA fuses elementwise chains and rounds once per fusion where the
  port rounds each op; a bf16 step is 2**-8 relative, and the backward
  sums many such products into one leaf.
* MoE routing: the port's top-k choices equal JAX's (recorded through a
  ``jax.debug.callback`` on ``jax.lax.top_k``) but for flips where the
  k-th and (k+1)-th router probabilities differ by less than
  ``ROUTE_GAP`` (1e-5 in f32, 2e-3 in bf16); any flip is printed.
* Remat on and off: the port's gradients are bitwise equal.
* One AdamW step: the composition of JAX's parts on JAX's gradients.  A
  first Adam step moves each weight by ``lr * g / (|g| + eps)`` of its
  clipped gradient, about ``lr * sign(g)``, so where |g| is near eps or
  0 a gradient error within the bound above moves the step by up to
  ``2 * lr``.  Each element is held within ``lr`` times the two
  packages' first-step difference, plus 1e-6 of its value and of
  ``lr``; the elements moved the other way are counted.
* Data: ``tokens_from_draws`` on JAX's own draws is bitwise JAX's
  ``synth_batch``.  Checkpoints: bitwise, in JAX's on-disk format.

Tests marked ``cuda`` hold a training step on the card against the CPU;
they skip where no GPU is present.
"""
import functools
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data import lm_data as jdata
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.api import get_model as jax_get_model
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.convert import from_numpy_tree
from repro_torch.data import lm_data as tdata
from repro_torch.kernels import ops
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as tlaunch
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.models.api import get_model
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop
from repro_torch.tree import leaves_with_paths, tree_leaves

ARCHS = ["tinyllama-1.1b", "llama3.2-1b", "moonshot-v1-16b-a3b",
         "internvl2-26b"]
DTYPES = ["float32", "bfloat16"]
DROP = "moonshot-v1-16b-a3b@cf0.5"
B, T = 2, 16
LEAF_TOL = {"float32": 1e-5, "bfloat16": 6e-2}
LOSS_RTOL = {"float32": 1e-6, "bfloat16": 2e-3}
ROUTE_GAP = {"float32": 1e-5, "bfloat16": 2e-3}

jax_init = jax.jit(JT.lm_init, static_argnums=1)


def configs(name, dtype):
    arch, _, over = name.partition("@")
    extra = {"capacity_factor": 0.5} if over == "cf0.5" else {}
    return (jax_smoke(arch).replace(dtype=dtype, **extra),
            get_smoke_config(arch).replace(dtype=dtype, **extra))


def draw_batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "patch_stub":
        toks = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    else:
        toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    return toks, labels


def port_batch(toks, labels):
    x = torch.from_numpy(toks)
    return {"tokens": x if x.is_floating_point() else x.long(),
            "labels": torch.from_numpy(labels).long()}


def flat(tree):
    return {p: (v.detach().float().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v, np.float32))
            for p, v in leaves_with_paths(tree)}


def jax_loss_and_grads(jcfg, params, toks, labels, monkeypatch):
    """JAX's jitted loss and gradient, with each ``top_k`` call's experts
    and router probabilities recorded in call order."""
    rec = []
    orig = jax.lax.top_k

    def tapped(x, k):
        vals, idx = orig(x, k)
        jax.debug.callback(
            lambda i, p: rec.append((np.asarray(i), np.asarray(p))), idx, x)
        return vals, idx
    monkeypatch.setattr(jax.lax, "top_k", tapped)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        jax_get_model(jcfg).loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params),
        {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    jax.block_until_ready(grads)
    monkeypatch.setattr(jax.lax, "top_k", orig)
    return dict(loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=flat(jax.tree_util.tree_map(np.asarray, grads)),
                routes=rec)


def port_loss_and_grads(tcfg, params, toks, labels, monkeypatch):
    rec = []
    orig = TM.route

    def tapped(p, cfg, xf):
        out = orig(p, cfg, xf)
        rec.append((out[2].numpy(), out[0].detach().numpy()))
        return out
    monkeypatch.setattr(TM, "route", tapped)
    (loss, metrics), grads = tloop.value_and_grad(
        get_model(tcfg).loss_fn, from_numpy_tree(params),
        port_batch(toks, labels))
    monkeypatch.setattr(TM, "route", orig)
    return dict(loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=flat(grads), grads_raw=grads, routes=rec)


@pytest.fixture(scope="module")
def runs():
    """JAX's and the port's (remat on and off) loss and gradients, once a
    config and dtype, shared by the tests."""
    out, f32_params = {}, {}
    key = jax.random.PRNGKey(0)
    with pytest.MonkeyPatch.context() as mp:
        for name in ARCHS + [DROP]:
            for dtype in DTYPES if name != DROP else ["float32"]:
                jcfg, tcfg = configs(name, dtype)
                # JAX's init draws in f32 and casts to the config's dtype
                # (the router stays f32): one compile an arch
                arch = name.partition("@")[0]
                if arch not in f32_params:
                    f32_params[arch] = jax_init(key, jcfg.replace(
                        dtype="float32"))
                params = jax.tree_util.tree_map(
                    lambda a, s: np.asarray(a).astype(s.dtype),
                    f32_params[arch], jax.eval_shape(
                        functools.partial(JT.lm_init, cfg=jcfg), key))
                toks, labels = draw_batch(jcfg)
                out[name, dtype] = dict(
                    jcfg=jcfg, tcfg=tcfg, params=params, toks=toks,
                    labels=labels,
                    jax=jax_loss_and_grads(jcfg, params, toks, labels, mp),
                    **{f"remat_{r}": port_loss_and_grads(
                        tcfg.replace(remat=r), params, toks, labels, mp)
                       for r in (True, False)})
    return out


# -------------------------------------------- loss and gradients --

@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(runs, arch, dtype, remat):
    r = runs[arch, dtype]
    j, t = r["jax"], r[f"remat_{remat}"]
    for key in ("loss", "ce", "moe_aux"):
        np.testing.assert_allclose(t["metrics"][key], j["metrics"][key],
                                   rtol=LOSS_RTOL[dtype], atol=1e-7,
                                   err_msg=key)
    assert t["loss"] == t["metrics"]["loss"]
    if r["tcfg"].n_experts:
        assert t["metrics"]["moe_aux"] > 0
    assert set(t["grads"]) == set(j["grads"])
    worst = 0.0
    for path, w in j["grads"].items():
        g = t["grads"][path]
        assert g.shape == w.shape, path
        allowed = LEAF_TOL[dtype] * np.abs(w).max()
        err = np.abs(g - w).max()
        assert err <= allowed, (path, err, allowed)
        if allowed:
            worst = max(worst, err / allowed)
        if path == ("embed", "table") and r["tcfg"].frontend == "patch_stub":
            assert not g.any() and not w.any()   # stub inputs skip it
        else:
            assert np.abs(g).max() > 0, path     # a gradient reaches it
    print(f"{arch} {dtype} remat={remat}: worst leaf at {worst:.3f} of its "
          f"allowance")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_bitwise(runs, arch, dtype):
    on, off = runs[arch, dtype]["remat_True"], runs[arch, dtype]["remat_False"]
    assert on["loss"] == off["loss"]
    for path, g in on["grads"].items():
        assert np.array_equal(g, off["grads"][path]), path


def flips(j_routes, t_routes, k, gap):
    """(layer, token, gap) of each token whose top-k expert set differs,
    the gap taken from JAX's router probabilities."""
    out = []
    for layer, ((je, jp), (te, _)) in enumerate(zip(j_routes, t_routes)):
        differ = np.any(np.sort(je, -1) != np.sort(te, -1), axis=-1)
        srt = -np.sort(-jp, axis=-1)
        gaps = srt[:, k - 1] - srt[:, k]
        out += [(layer, int(i), float(gaps[i])) for i in np.flatnonzero(
            differ)]
    return out


@pytest.mark.parametrize("name,dtype", [("moonshot-v1-16b-a3b", d)
                                        for d in DTYPES] + [(DROP,
                                                             "float32")])
def test_routing_matches_jax(runs, name, dtype):
    r = runs[name, dtype]
    k, n_layers = r["tcfg"].experts_per_token, r["tcfg"].n_layers
    j_routes = r["jax"]["routes"]
    assert len(j_routes) == n_layers
    for remat in (True, False):
        t_routes = r[f"remat_{remat}"]["routes"]
        assert len(t_routes) == n_layers * (2 if remat else 1)
        found = flips(j_routes, t_routes[:n_layers], k, ROUTE_GAP[dtype])
        if found:
            print(f"{name} {dtype}: routing flips (layer, token, gap): "
                  f"{found}")
        assert all(g < ROUTE_GAP[dtype] for _, _, g in found), found


def test_remat_recompute_takes_the_first_routing(runs):
    """Under remat the backward runs each MoE layer again: its routing is
    the first pass's, call for call (layer 1 then layer 0)."""
    r = runs["moonshot-v1-16b-a3b", "bfloat16"]["remat_True"]["routes"]
    assert len(r) == 4
    for first, again in ((r[0], r[3]), (r[1], r[2])):
        assert np.array_equal(first[0], again[0])
        assert np.array_equal(first[1], again[1])


def test_capacity_drops_and_their_gradient(runs):
    """At capacity factor 0.5 entries drop; the gradients still match
    JAX's (the dropped entries get none), and a token whose every entry
    dropped gets no gradient through the layer's output."""
    _, tcfg = configs(DROP, "float32")
    rng = np.random.default_rng(3)
    p_np = {"router": {"w": rng.standard_normal((64, 8)).astype(np.float32)
                       / 8},
            "gate_w": rng.standard_normal((8, 64, 64)).astype(np.float32)
            / 8,
            "up_w": rng.standard_normal((8, 64, 64)).astype(np.float32) / 8,
            "down_w": rng.standard_normal((8, 64, 64)).astype(np.float32)
            / 8}
    x = rng.standard_normal((2, 32, 64)).astype(np.float32)
    cot = rng.standard_normal((2, 32, 64)).astype(np.float32)
    jcfg, _ = configs(DROP, "float32")

    def j_loss(p, x):
        y, _ = JM.moe_apply(p, jcfg, x)
        return jnp.sum(y * cot)
    jgp, jgx = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(
        jax.tree_util.tree_map(jnp.asarray, p_np), jnp.asarray(x))
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(a)
                                .requires_grad_(True), p_np)
    tx = torch.from_numpy(x).requires_grad_(True)
    xf = tx.detach().reshape(-1, 64)
    _, _, top_e = TM.route(tp, tcfg, xf)
    disp = TM.dispatch(tcfg, xf, top_e, TM.capacity(tcfg, 64))
    assert int((~disp.keep).sum()) > 0
    y, _ = TM.moe_apply(tp, tcfg, tx)
    gx, *gp = torch.autograd.grad((y * torch.from_numpy(cot)).sum(),
                                  [tx] + tree_leaves(tp))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jgx)).max())
    for g, w in zip(gp, jax.tree_util.tree_leaves(jgp)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
    # tokens with every entry dropped: no output, so no gradient
    kept = torch.zeros(64 * 2, dtype=torch.bool)
    kept[disp.order[disp.keep]] = True
    gone = ~kept.reshape(64, 2).any(-1)
    assert torch.all(y.reshape(64, 64)[gone] == 0)
    assert torch.all(gx.reshape(64, 64)[gone] == 0)


def test_stacked_leaves_get_one_gradient_stack(runs):
    """Each stacked block leaf reaches the graph through one
    ``UnbindBackward0`` (one [L, ...] gradient), not L selects."""
    r = runs["moonshot-v1-16b-a3b", "float32"]
    params = from_numpy_tree(r["params"])
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss, _ = get_model(r["tcfg"]).loss_fn(params, port_batch(r["toks"],
                                                              r["labels"]))
    users = {}
    seen, todo = set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if nxt is not None and type(nxt).__name__ == "AccumulateGrad":
                users.setdefault(id(nxt.variable), []).append(
                    type(node).__name__)
            todo.append(nxt)
    blocks = tree_leaves(params["blocks"])
    for leaf in blocks:
        assert users[id(leaf)] == ["UnbindBackward0"], users[id(leaf)]
    assert len(blocks) == 10


# ----------------------------------------------------- the step --

def test_train_step_matches_jax_parts(runs):
    """``build_train_step`` (AdamW) against JAX's ``clip_by_global_norm``,
    ``cosine_lr`` and ``adamw_update`` composed on JAX's gradients."""
    r = runs["tinyllama-1.1b", "float32"]
    step = 3
    jtc = JaxTrainConfig(optimizer="adamw", lr=3e-4, lr_min=3e-5, steps=10)
    tc = TrainConfig(optimizer="adamw", lr=3e-4, lr_min=3e-5, steps=10)
    jparams = jax.tree_util.tree_map(jnp.asarray, r["params"])
    jgrads = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jparams),
        [jnp.asarray(r["jax"]["grads"][p]) for p, _ in
         leaves_with_paths(r["params"])])
    j_init, j_upd = jopt.get_optimizer(jtc)

    @jax.jit
    def jax_step(params, grads, step):
        g, gnorm = jopt.clip_by_global_norm(grads, 1.0)
        lr = jopt.cosine_lr(step, jtc)
        return j_upd(g, j_init(params), params, lr, jtc) + (gnorm, lr)
    want, want_opt, gnorm, lr = jax_step(jparams, jgrads,
                                         jnp.asarray(step, jnp.int32))

    train_step, init_opt = tsteps.build_train_step(get_model(r["tcfg"]), tc)
    params = from_numpy_tree(r["params"])
    got, opt, m = train_step(params, init_opt(params),
                             port_batch(r["toks"], r["labels"]), step)
    np.testing.assert_allclose(float(m["grad_norm"]), float(gnorm),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["lr"]), float(lr), rtol=1e-6)
    np.testing.assert_allclose(float(m["loss"]), r["jax"]["loss"],
                               rtol=1e-6)
    assert set(m) == {"loss", "ce", "moe_aux", "grad_norm", "lr"}
    assert int(opt["count"]) == int(want_opt["count"]) == 1
    want, got, jg, tg = (flat(want), flat(got), r["jax"]["grads"],
                         r["remat_True"]["grads"])
    lr, eps = float(lr), 1e-8

    def first_step(g, norm):
        """Adam's first step of one package's clipped gradient."""
        g = g * min(1.0, 1.0 / (norm + 1e-9))
        return g / (np.abs(g) + eps)
    other_way = 0
    for path, w in want.items():
        s_j = first_step(jg[path], float(gnorm))
        s_t = first_step(tg[path], float(m["grad_norm"]))
        other_way += int((np.sign(s_j) != np.sign(s_t)).sum())
        allowed = lr * np.abs(s_t - s_j) + 1e-6 * np.abs(w) + 1e-6 * lr
        err = np.abs(got[path] - w)
        assert np.all(err <= allowed), (path, float(err.max()))
    print(f"one AdamW step: {other_way} elements moved the other way "
          f"(their gradients within the float32 bound of 0)")


def test_backward_runs_under_f32_sums():
    """The loss and its backward both see cuBLAS's bf16 reduced-precision
    sums and TF32 off; the caller's flags come back after."""
    m = torch.backends.cuda.matmul
    seen = []

    class Spy(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            seen.append(("fwd", m.allow_bf16_reduced_precision_reduction,
                         m.allow_tf32))
            return x * 1.0

        @staticmethod
        def backward(ctx, g):
            seen.append(("bwd", m.allow_bf16_reduced_precision_reduction,
                         m.allow_tf32))
            return g

    def loss_fn(p, batch):
        loss = (Spy.apply(p["w"]) * batch["x"]).sum()
        return loss, {"loss": loss}
    saved = m.allow_bf16_reduced_precision_reduction, m.allow_tf32
    m.allow_bf16_reduced_precision_reduction, m.allow_tf32 = True, True
    try:
        (_, _), g = tloop.value_and_grad(
            loss_fn, {"w": torch.ones(3)}, {"x": torch.arange(3.0)})
        assert (m.allow_bf16_reduced_precision_reduction,
                m.allow_tf32) == (True, True)
    finally:
        m.allow_bf16_reduced_precision_reduction, m.allow_tf32 = saved
    assert seen == [("fwd", False, False), ("bwd", False, False)]
    assert torch.equal(g["w"], torch.arange(3.0))


def test_fit_trains_an_lm(tmp_path, capsys):
    """``fit(get_model(cfg), tc, data)`` on the synthetic stream: the loss
    falls over 20 AdamW steps."""
    cfg = get_smoke_config("tinyllama-1.1b")
    tc = TrainConfig(optimizer="adamw", lr=1e-3, lr_min=1e-4, steps=20,
                     batch_size=4, checkpoint_every=0,
                     checkpoint_dir=str(tmp_path))
    losses = []
    tloop.fit(get_model(cfg), tc,
              lambda s: tdata.stream(0, 4, 32, cfg.vocab_size, s,
                                     device="cpu"),
              hooks={"on_step": lambda s, p, m: losses.append(
                  float(m["loss"]))}, device="cpu")
    assert len(losses) == 20
    assert np.mean(losses[-5:]) < losses[0] - 0.3, losses
    capsys.readouterr()


# ------------------------------------------------------- refusals --

def test_flash_refuses_a_gradient_and_serves_without():
    cfg = get_smoke_config("tinyllama-1.1b").replace(attn_impl="flash")
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    toks, labels = draw_batch(cfg)
    batch = port_batch(toks, labels)
    with pytest.raises(NotImplementedError,
                       match="no backward.*attn_impl='xla' or 'xla_chunked'"):
        tloop.value_and_grad(api.loss_fn, params, batch)
    for remat in (True, False):
        with pytest.raises(NotImplementedError, match="no backward"):
            tloop.value_and_grad(get_model(cfg.replace(
                remat=remat)).loss_fn, params, batch)
    q = torch.randn(1, 4, 8, 16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="flash_attention"):
        ops.flash_attention(q, q, q)
    # serving: no gradient asked, the flash route's output as before
    with torch.no_grad():
        want = ops.flash_attention(q, q, q)
        served, _ = api.forward(params, batch["tokens"])
    assert torch.equal(ops.flash_attention(q.detach(), q.detach(),
                                           q.detach()), want)
    plain, _ = get_model(cfg.replace(attn_impl="xla")).forward(
        params, batch["tokens"])
    torch.testing.assert_close(served, plain, rtol=0,
                               atol=4e-2 * float(plain.abs().max()))


def test_step_functions_and_profiles(runs):
    """Without a mesh ``fsdp``, ``infer2d``, ``cache_seq`` and
    ``moe_local`` place every leaf whole: their train and prefill steps
    are the ``default`` ones bitwise, as JAX's are on one device;
    ``infer2d``'s step is ``fsdp``'s bitwise."""
    r = runs["tinyllama-1.1b", "float32"]
    api = get_model(r["tcfg"])
    tc = TrainConfig(optimizer="adamw")
    params = from_numpy_tree(r["params"])
    ids = torch.from_numpy(r["toks"]).long()
    batch = port_batch(r["toks"], r["labels"])
    step, init_opt = tsteps.build_train_step(api, tc)
    want = step(params, init_opt(params), batch, 0)
    for profile in ("fsdp", "moe_local", "replicated", "cache_seq"):
        step, _ = tsteps.build_train_step(api, tc, profile=profile)
        got = step(params, init_opt(params), batch, 0)
        for (p, a), (_, b) in zip(leaves_with_paths(got[0]),
                                  leaves_with_paths(want[0])):
            assert torch.equal(a, b), (profile, p)
        assert torch.equal(got[2]["loss"], want[2]["loss"])
    fsdp = tsteps.build_train_step(api, tc, profile="fsdp")[0](
        params, init_opt(params), batch, 0)
    step, _ = tsteps.build_train_step(api, tc, profile="infer2d")
    got = step(params, init_opt(params), batch, 0)
    for (p, a), (_, b) in zip(leaves_with_paths(got[0]),
                              leaves_with_paths(fsdp[0])):
        assert torch.equal(a, b), ("infer2d", p)
    assert torch.equal(got[2]["loss"], fsdp[2]["loss"])
    cache = api.init_cache(B, T + 1, device="cpu")
    logits, cache = tsteps.build_prefill_step(api)(params, {"tokens": ids},
                                                   cache)
    local, _ = tsteps.build_prefill_step(api, "moe_local")(
        params, {"tokens": ids}, api.init_cache(B, T + 1, device="cpu"))
    assert torch.equal(local, logits)
    full, _ = api.forward(params, ids)
    torch.testing.assert_close(logits, full[:, -1], rtol=1e-4, atol=1e-4)
    nxt = logits.argmax(-1)
    step_logits, _ = tsteps.build_decode_step(api)(
        params, {"token": nxt, "pos": T}, cache)
    want, _ = api.forward(params, torch.cat([ids, nxt[:, None]], 1))
    torch.testing.assert_close(step_logits, want[:, -1], rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------- launch --

def test_launch_train_runs_and_resumes(tmp_path, capsys):
    """Five steps straight, then the same command again after a crash
    that lost the checkpoints of steps 4 and 5: it resumes at step 3 and
    ends bitwise where the straight run did."""
    argv = ["--arch", "tinyllama-1.1b", "--smoke", "--batch", "2", "--seq",
            "16", "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--steps", "5"]
    straight = tlaunch.main(argv)
    out = capsys.readouterr().out
    assert "done: loss" in out and "(step 0)" in out and "(step 4)" in out
    assert tckpt.latest_step(str(tmp_path)) == 5
    assert straight["params"]["blocks"]["attn"]["wq"]["w"].dtype == \
        torch.bfloat16
    for d in (tmp_path, tmp_path / "opt"):
        for step in (4, 5):
            sub = d / f"step_{step:08d}"
            for f in sub.iterdir():
                f.unlink()
            sub.rmdir()
    resumed = tlaunch.main(argv)
    out = capsys.readouterr().out
    assert "(step 3)" in out and "(step 4)" in out and "(step 0)" not in out
    assert tckpt.latest_step(str(tmp_path)) == 5
    for (p, a), (_, b) in zip(leaves_with_paths(straight["params"]),
                              leaves_with_paths(resumed["params"])):
        assert torch.equal(a, b), p
    assert tlaunch.main(argv)["history"] == []
    assert "at step 5 already" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--production-mesh"],
                                  ["--profile", "fsdp"],
                                  ["--profile", "infer2d"]])
def test_launch_refuses_sharded_flags(flag, tmp_path):
    """``--production-mesh`` in one process raises ``ValueError`` (its
    mesh spans 256 ranks) before writing anything; ``--profile fsdp`` on
    the host (no ``model`` axis: every leaf whole, the batch over
    ``data``) trains bitwise as ``default`` does, and ``--profile
    infer2d`` (``fsdp``'s rules) bitwise as ``fsdp`` does."""
    argv = ["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu",
            "--steps", "1", "--batch", "2", "--seq", "16"]
    if flag[0] == "--profile":
        want = ["--profile", "fsdp"] if flag[-1] == "infer2d" else []
        got = tlaunch.main(argv + flag + ["--ckpt-dir", str(tmp_path / "a")])
        want = tlaunch.main(argv + want + ["--ckpt-dir", str(tmp_path / "b")])
        for (p, a), (_, b) in zip(leaves_with_paths(got["params"]),
                                  leaves_with_paths(want["params"])):
            assert torch.equal(a, b), p
        return
    with pytest.raises(ValueError, match="256 devices"):
        tlaunch.main(argv + ["--ckpt-dir", str(tmp_path)] + flag)
    assert tckpt.latest_step(str(tmp_path)) is None


def test_launch_grad_compress_bits_reaches_train_config(tmp_path,
                                                        monkeypatch, capsys):
    """``--grad-compress-bits 8`` trains and lands in ``TrainConfig``, as
    JAX's launcher passes it (whose ``fit`` does not read it either), and
    the launcher says that nothing reads it."""
    seen = []
    real_fit = tlaunch.fit

    def spy(api, tc, *a, **kw):
        seen.append(tc)
        return real_fit(api, tc, *a, **kw)
    monkeypatch.setattr(tlaunch, "fit", spy)
    out = tlaunch.main(["--arch", "tinyllama-1.1b", "--smoke", "--batch",
                        "2", "--seq", "16", "--device", "cpu", "--steps",
                        "2", "--grad-compress-bits", "8", "--ckpt-dir",
                        str(tmp_path)])
    assert [tc.grad_compress_bits for tc in seen] == [8]
    assert "fit does not read it" in capsys.readouterr().err
    assert np.isfinite(out["history"][0]["loss"])
    assert tckpt.latest_step(str(tmp_path)) == 2


# ------------------------------------------------------------ data --

@pytest.mark.parametrize("vocab", [512, 32000, 163840])
def test_tokens_from_draws_is_jax_synth_batch(vocab):
    for seed, step, host in ((0, 0, 0), (3, 7, 1)):
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(seed), step), host)
        k1, k2 = jax.random.split(key)
        u = np.asarray(jax.random.uniform(k1, (8, 129), minval=1e-6))
        copy = np.asarray(jax.random.bernoulli(k2, 0.3, (8, 129)))
        want = jdata.synth_batch(seed, step, 8, 128, vocab, host)
        toks = tdata.tokens_from_draws(u, copy, vocab)
        assert toks.dtype == np.int32
        np.testing.assert_array_equal(toks[:, :-1],
                                      np.asarray(want["tokens"]))
        np.testing.assert_array_equal(toks[:, 1:],
                                      np.asarray(want["labels"]))


def test_exp_f32_is_xla_exp():
    x = np.linspace(-20.0, 12.5, 400001, dtype=np.float32)
    np.testing.assert_array_equal(tdata.exp_f32(x),
                                  np.asarray(jnp.exp(jnp.asarray(x))))


class TestData:
    def test_batch_deterministic_in_seed_step_host(self):
        a = tdata.synth_batch(1, 4, 3, 32, 512, device="cpu")
        b = tdata.synth_batch(1, 4, 3, 32, 512, device="cpu")
        for k in ("tokens", "labels"):
            assert torch.equal(a[k], b[k]) and a[k].dtype == torch.int64
            assert a[k].shape == (3, 32) and a[k].is_contiguous()
        for other in ((2, 4, 0), (1, 5, 0), (1, 4, 1)):
            c = tdata.synth_batch(other[0], other[1], 3, 32, 512,
                                  host_id=other[2], device="cpu")
            assert not torch.equal(a["tokens"], c["tokens"]), other

    def test_stream_realigned(self):
        it = tdata.stream(2, 2, 16, 512, start_step=5, device="cpu")
        for step in (5, 6, 7):
            got = next(it)
            want = tdata.synth_batch(2, step, 2, 16, 512, device="cpu")
            assert torch.equal(got["tokens"], want["tokens"])

    def test_labels_are_the_tokens_shifted(self):
        b = tdata.synth_batch(0, 0, 4, 64, 512, device="cpu")
        assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    @pytest.mark.parametrize("vocab", [2, 50, 32000])
    def test_tokens_in_range_zipf_and_copied(self, vocab):
        b = tdata.synth_batch(0, 3, 8, 256, vocab, device="cpu")
        t = b["tokens"]
        assert int(t.min()) >= 0 and int(t.max()) < vocab
        assert int(b["labels"].max()) < vocab
        if vocab > 2:
            # Zipf: the low ids dominate; copies repeat a neighbour
            assert float((t < vocab // 10).float().mean()) > 0.2
            assert float((t[:, 1:] == t[:, :-1]).float().mean()) > 0.15


# ----------------------------------------------------- checkpoints --

def bf16_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(3, 4, generator=g).to(torch.bfloat16),
            "s": [torch.randn(5, generator=g).to(torch.bfloat16),
                  torch.arange(4, dtype=torch.int32)],
            "f": torch.randn(2, generator=g)}


def npy_payload(raw: bytes) -> bytes:
    """An .npy file's array bytes (after its header)."""
    hlen = int.from_bytes(raw[8:10], "little")
    return raw[10 + hlen:]


class TestCheckpoint:
    def test_bf16_save_is_jax_format(self, tmp_path):
        tree = bf16_tree()
        jtree = jax.tree_util.tree_map(
            lambda t: jnp.asarray(t.float().numpy()).astype(
                jnp.bfloat16 if t.dtype == torch.bfloat16 else
                t.numpy().dtype), tree)
        dj = jckpt.save(str(tmp_path / "jax"), 2, jtree)
        dt = tckpt.save(str(tmp_path / "port"), 2, tree)
        mj = json.loads((dj / "manifest.json").read_text())
        mt = json.loads((dt / "manifest.json").read_text())
        assert mt == mj
        assert mt["leaves"]["w"] == {"shape": [3, 4], "dtype": "bfloat16"}
        with zipfile.ZipFile(dj / "shards_host0.npz") as zj, \
                zipfile.ZipFile(dt / "shards_host0.npz") as zt:
            assert sorted(zj.namelist()) == sorted(zt.namelist())
            for name in zj.namelist():
                assert npy_payload(zj.read(name)) == npy_payload(
                    zt.read(name)), name
        with np.load(dt / "shards_host0.npz") as z:
            assert z["w"].dtype == np.dtype("V2")

    def test_jax_bf16_checkpoint_restores_bitwise(self, tmp_path):
        rng = np.random.default_rng(4)
        jtree = {"a": jnp.asarray(rng.standard_normal((6, 7)),
                                  jnp.bfloat16),
                 "b": jnp.asarray(rng.standard_normal(3), jnp.float32)}
        jckpt.save(str(tmp_path), 9, jtree, extra={"step": 9})
        tmpl = {"a": torch.zeros(6, 7, dtype=torch.bfloat16),
                "b": torch.zeros(3)}
        back, extra = tckpt.restore(str(tmp_path), 9, tmpl)
        assert extra == {"step": 9} and back["a"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            back["a"].view(torch.uint16).numpy(),
            np.asarray(jtree["a"]).view(np.uint16))
        np.testing.assert_array_equal(back["b"].numpy(),
                                      np.asarray(jtree["b"]))

    def test_bf16_params_and_adamw_state_round_trip(self, runs, tmp_path):
        r = runs["moonshot-v1-16b-a3b", "bfloat16"]
        params = from_numpy_tree(r["params"])
        init_opt, update = topt.get_optimizer(TrainConfig(optimizer="adamw"))
        opt = init_opt(params)
        params, opt = update(r["remat_True"]["grads_raw"], opt, params,
                             torch.tensor(1e-3), TrainConfig())
        saver = tckpt.AsyncCheckpointer(str(tmp_path))
        saver.save(1, params, extra={"step": 1})
        tckpt.save(str(tmp_path / "opt"), 1, opt)
        saver.wait()
        back, _ = tckpt.restore(str(tmp_path), 1, params)
        back_opt, _ = tckpt.restore(str(tmp_path / "opt"), 1, opt)
        for tree, got in ((params, back), (opt, back_opt)):
            for (path, a), (_, b) in zip(leaves_with_paths(tree),
                                         leaves_with_paths(got)):
                assert a.dtype == b.dtype and torch.equal(a, b), path
        assert params["blocks"]["attn"]["wq"]["w"].dtype == torch.bfloat16
        assert opt["m"]["embed"]["table"].dtype == torch.float32


# ------------------------------------------------------------ card --

@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "moonshot-v1-16b-a3b"])
def test_card_train_step_matches_cpu(arch):
    """One AdamW step of the f32 smoke config on the card against the
    CPU: the loss within 1e-5, each gradient leaf within 1e-4 of its
    max|g|; flash refuses a gradient there too, before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    cfg = get_smoke_config(arch).replace(dtype="float32")
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    toks, labels = draw_batch(cfg)
    batch = port_batch(toks, labels)
    out = {}
    for dev in ("cpu", "cuda"):
        out[dev] = tloop.value_and_grad(
            api.loss_fn, _to(params, dev),
            {k: v.to(dev) for k, v in batch.items()})
    (lc, _), gc = out["cuda"]
    (lh, _), gh = out["cpu"]
    np.testing.assert_allclose(float(lc), float(lh), rtol=1e-5)
    for (path, a), (_, b) in zip(leaves_with_paths(gc),
                                 leaves_with_paths(gh)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                   atol=1e-4 * float(b.abs().max()),
                                   err_msg=str(path))
    flash_attention_cuda.launches = 0
    with pytest.raises(NotImplementedError, match="no backward"):
        tloop.value_and_grad(get_model(cfg.replace(
            attn_impl="flash")).loss_fn, _to(params, "cuda"),
            {k: v.cuda() for k, v in batch.items()})
    assert flash_attention_cuda.launches == 0


def _to(tree, dev):
    from repro_torch.api.build import to_device
    return to_device(tree, dev)
