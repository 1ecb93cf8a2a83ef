"""Parity of the port's training of xLSTM, Hymba and the Whisper enc-dec
with ``repro``: ``loss_fn`` and its gradients, remat, the chunk scan's
and the sLSTM cell's backward, one AdamW step, ``fit`` and
``launch.train``.

Both packages run the JAX smoke configs of ``xlstm-1.3b`` (two groups of
one mLSTM and one sLSTM, d_model 64), ``hymba-1.5b`` (2 layers, window
16, SSM state 8) and ``whisper-tiny`` (2 + 2 layers, 16 stub frames,
tied embeddings) on the same parameters (drawn by the JAX inits, carried
across by ``convert``) and the same inputs (``np.random.default_rng``).
JAX's loss and gradients are ``jax.value_and_grad(api.loss_fn,
has_aux=True)``, jitted, at the smoke configs' ``remat`` (off); the
port's go through ``train.train_loop.value_and_grad`` with ``remat`` on
and off.  JAX's ``build_train_step`` and ``fit`` fail at
``rules.constrain_batch`` under jax 0.9.0, so its step is composed from
its parts, as ``tests/test_torch_lm_train.py`` does.

Tolerances, as ``tests/test_torch_lm_train.py`` states them:

* float32: each gradient leaf within 1e-5 of its own max|g|, the loss
  within rtol 1e-6 (sums taken in another order, XLA's against
  PyTorch's).
* bfloat16 (Hymba, Whisper and xLSTM): each leaf within 6e-2 of its own
  max|g|, the loss within rtol 2e-3.  XLA fuses elementwise chains and
  rounds once a fusion where the port rounds each op.  The worst leaf is
  printed.
* Remat on and off: the port's gradients are bitwise equal.
* The chunk scan: gradients of q, k, v, log f and the input gate within
  1e-5 of each one's max|g| of JAX's ``chunked_scan`` and 1e-4 of the
  port's own ``reference_scan`` under autograd (an O(T) loop: its sums
  run in another order than the chunk products').
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models import encdec as JE
from repro.models import hymba as JH
from repro.models import linear_scan as JS
from repro.models import xlstm as JX
from repro.models.api import get_model as jax_get_model
from repro.train import optimizer as jopt
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.convert import from_numpy_tree
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as tlaunch
from repro_torch.models import linear_scan as TS
from repro_torch.models import xlstm as TX
from repro_torch.models.api import get_model
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import train_loop as tloop
from repro_torch.tree import leaves_with_paths, tree_leaves

ARCHS = ["xlstm-1.3b", "hymba-1.5b", "whisper-tiny"]
DTYPES = ["float32", "bfloat16"]
B, T = 2, 24
LEAF_TOL = {"float32": 1e-5, "bfloat16": 6e-2}
LOSS_RTOL = {"float32": 1e-6, "bfloat16": 2e-3}
STACKS = {"xlstm-1.3b": ("mblocks", "sblocks"), "hymba-1.5b": ("blocks",),
          "whisper-tiny": ("enc_blocks", "dec_blocks")}

JAX_INIT = {"xlstm-1.3b": JX.xlstm_init, "hymba-1.5b": JH.hymba_init,
            "whisper-tiny": JE.encdec_init}
_jit_init = {arch: jax.jit(fn, static_argnums=1)
             for arch, fn in JAX_INIT.items()}


def configs(arch, **over):
    return (jax_smoke(arch).replace(**over),
            get_smoke_config(arch).replace(**over))


def draw_batch(cfg, seed=1, b=B, t=T):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, t)).astype(
        np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, t)).astype(
        np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def port_batch(batch):
    return {k: torch.from_numpy(v) if v.dtype == np.float32
            else torch.from_numpy(v).long() for k, v in batch.items()}


def flat(tree):
    return {p: (v.detach().float().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v, np.float32))
            for p, v in leaves_with_paths(tree)}


def jax_loss_and_grads(jcfg, params, batch):
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        jax_get_model(jcfg).loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=flat(jax.tree_util.tree_map(np.asarray, grads)))


def port_loss_and_grads(tcfg, params, batch):
    (loss, metrics), grads = tloop.value_and_grad(
        get_model(tcfg).loss_fn, from_numpy_tree(params), port_batch(batch))
    return dict(loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=flat(grads))


@pytest.fixture(scope="module")
def runs():
    """JAX's and the port's (remat on and off) loss and gradients, once an
    arch and dtype, shared by the tests."""
    out = {}
    key = jax.random.PRNGKey(0)
    for arch in ARCHS:
        # JAX's init draws in f32 and casts to the config's dtype (its f32
        # leaves stay f32): one compile an arch
        f32 = _jit_init[arch](key, jax_smoke(arch).replace(dtype="float32"))
        for dtype in DTYPES:
            jcfg, tcfg = configs(arch, dtype=dtype)
            params = jax.tree_util.tree_map(
                lambda a, s: np.asarray(a).astype(s.dtype), f32,
                jax.eval_shape(functools.partial(JAX_INIT[arch], cfg=jcfg),
                               key))
            batch = draw_batch(jcfg)
            out[arch, dtype] = dict(
                jcfg=jcfg, tcfg=tcfg, params=params, batch=batch,
                jax=jax_loss_and_grads(jcfg, params, batch),
                **{f"remat_{r}": port_loss_and_grads(
                    tcfg.replace(remat=r), params, batch)
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
    assert t["loss"] == t["metrics"]["loss"] and t["metrics"]["moe_aux"] == 0
    assert set(t["grads"]) == set(j["grads"])
    worst = 0.0
    for path, w in j["grads"].items():
        g = t["grads"][path]
        assert g.shape == w.shape, path
        allowed = LEAF_TOL[dtype] * np.abs(w).max()
        err = np.abs(g - w).max()
        assert err <= allowed, (path, err, allowed)
        assert np.abs(g).max() > 0, path          # a gradient reaches it
        worst = max(worst, err / allowed)
    print(f"{arch} {dtype} remat={remat}: worst leaf at {worst:.3f} of its "
          f"allowance")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_bitwise(runs, arch, dtype):
    on, off = runs[arch, dtype]["remat_True"], runs[arch, dtype]["remat_False"]
    assert on["loss"] == off["loss"]
    for path, g in on["grads"].items():
        assert np.array_equal(g, off["grads"][path]), path


# ----------------------------------------------------- chunk scan --

def scan_inputs(t, log_f=None, seed=2, h=3, dk=8, dv=12):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((2, h, t, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((2, h, t, dv)).astype(np.float32)
    if log_f is None:
        log_f = np.log(rng.uniform(0.5, 0.999, (2, h, t))).astype(
            np.float32)
    i = rng.uniform(0.05, 1.0, (2, h, t)).astype(np.float32)
    cot = rng.standard_normal((2, h, t, dv)).astype(np.float32)
    return [q, k, v, log_f, i], cot


def scan_grads_jax(args, cot, chunk, normalize):
    def f(*a):
        return jnp.sum(JS.chunked_scan(*a, chunk=chunk, normalize=normalize)
                       * cot)
    return [np.asarray(g) for g in jax.jit(jax.grad(
        f, argnums=(0, 1, 2, 3, 4)))(*map(jnp.asarray, args))]


def scan_grads_port(fn, args, cot):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = fn(*ts)
    return [g.numpy() for g in torch.autograd.grad(
        (out * torch.from_numpy(cot)).sum(), ts)], out


def held(got, want, tol, what):
    for name, g, w in zip(("q", "k", "v", "log_f", "i_gate"), got, want):
        assert np.isfinite(g).all(), (what, name)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=tol * np.abs(w).max(),
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("normalize", [True, False])
def test_chunked_scan_gradients_match_jax_and_reference(normalize):
    """T 48 in chunks of 16 (three carried chunk states)."""
    args, cot = scan_inputs(48)
    want = scan_grads_jax(args, cot, 16, normalize)
    got, out = scan_grads_port(functools.partial(
        TS.chunked_scan, chunk=16, normalize=normalize), args, cot)
    held(got, want, 1e-5, "against JAX")
    ref, _ = scan_grads_port(functools.partial(
        TS.reference_scan, normalize=normalize), args, cot)
    held(got, ref, 1e-4, "against reference_scan")
    # the chunk states are stacked, not written in place
    seen, todo, kinds = set(), [out.grad_fn], set()
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        kinds.add(type(node).__name__)
        todo += [n for n, _ in node.next_functions]
    assert "CopySlices" not in kinds and "StackBackward0" in kinds


@pytest.mark.parametrize("normalize", [True, False])
def test_chunked_scan_gradients_finite_at_tiny_forget_gates(normalize):
    """log f near -80 over whole chunks: the masked upper triangle's log
    ratios reach +1280 (exp overflows), and the gradients stay finite and
    JAX's."""
    rng = np.random.default_rng(5)
    lf = (-80.0 + rng.uniform(-1.0, 1.0, (2, 3, 32))).astype(np.float32)
    lf[:, :, 16:20] = np.log(0.9)                  # a few live steps
    args, cot = scan_inputs(32, log_f=lf)
    want = scan_grads_jax(args, cot, 16, normalize)
    got, _ = scan_grads_port(functools.partial(
        TS.chunked_scan, chunk=16, normalize=normalize), args, cot)
    held(got, want, 1e-5, "log f near -80")


def test_slstm_cell_gradient_matches_jax():
    jcfg, tcfg = configs("xlstm-1.3b", dtype="float32")
    rng = np.random.default_rng(7)
    d, h = 64, tcfg.n_heads
    p = {"r": (rng.standard_normal((h, d // h, 4 * d // h)) / 6).astype(
        np.float32)}
    xt = rng.standard_normal((B, 4 * d)).astype(np.float32)
    st = {k: rng.uniform(0.1, 1.0, (B, d)).astype(np.float32)
          for k in ("c", "n", "h")}
    cots = {k: rng.standard_normal((B, d)).astype(np.float32)
            for k in ("c", "n", "h")}

    def j_loss(p, xt, st):
        new, _ = JX._slstm_cell(p, jcfg, xt, st)
        return sum(jnp.sum(new[k] * cots[k]) for k in cots)
    jg = jax.grad(j_loss, argnums=(0, 1, 2))(
        {"r": jnp.asarray(p["r"])}, jnp.asarray(xt),
        {k: jnp.asarray(v) for k, v in st.items()})
    tp = {"r": torch.from_numpy(p["r"]).requires_grad_(True)}
    txt = torch.from_numpy(xt).requires_grad_(True)
    tst = {k: torch.from_numpy(v).requires_grad_(True) for k, v in st.items()}
    new, _ = TX._slstm_cell(tp, tcfg, txt, tst)
    loss = sum((new[k] * torch.from_numpy(cots[k])).sum() for k in cots)
    tg = torch.autograd.grad(loss, [tp["r"], txt] + [tst[k] for k in
                                                     sorted(tst)])
    want = [jg[0]["r"], jg[1]] + [jg[2][k] for k in sorted(st)]
    for g, w in zip(tg, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


# ---------------------------------------------------------- remat --

def checkpoint_log(monkeypatch):
    """Record the layer (a ``functools.partial``) each
    ``torch.utils.checkpoint.checkpoint`` call runs, and whether each call
    of ``slstm_block_apply`` is made inside one."""
    calls, inside = [], []
    orig = torch.utils.checkpoint.checkpoint
    depth = [0]

    def spy(fn, *a, **kw):
        layer, = [c.cell_contents for c in fn.__closure__
                  if isinstance(c.cell_contents, functools.partial)]
        calls.append(layer)
        depth[0] += 1
        try:
            return orig(fn, *a, **kw)
        finally:
            depth[0] -= 1
    s_orig = TX.slstm_block_apply

    def s_spy(*a, **kw):
        inside.append(depth[0] > 0)
        return s_orig(*a, **kw)
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", spy)
    monkeypatch.setattr(TX, "slstm_block_apply", s_spy)
    return calls, inside


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_checkpoints_the_layers_jax_does(runs, arch, monkeypatch):
    """xLSTM: each mLSTM layer and no sLSTM block; Hymba: each layer;
    Whisper: each encoder and each decoder layer.  Each checkpoint runs
    its own layer's params (bound, not a loop variable), in layer order.
    None without ``remat``, and none in a forward without a gradient."""
    r = runs[arch, "float32"]
    cfg = r["tcfg"]
    want = {"xlstm-1.3b": ["mlstm_block_apply"] * 2,
            "hymba-1.5b": ["hymba_block_apply"] * cfg.n_layers,
            "whisper-tiny": ["_enc_layer"] * cfg.n_enc_layers
            + ["_dec_layer"] * cfg.n_layers}[arch]
    calls, inside = checkpoint_log(monkeypatch)
    params = from_numpy_tree(r["params"])
    for remat in (True, False):
        calls.clear()
        tloop.value_and_grad(get_model(cfg.replace(remat=remat)).loss_fn,
                             params, port_batch(r["batch"]))
        assert [c.func.__name__ for c in calls] == (want if remat else [])
    # each layer a slice of its own stack, in layer order
    calls.clear()
    tloop.value_and_grad(get_model(cfg.replace(remat=True)).loss_fn, params,
                         port_batch(r["batch"]))
    for name in set(want):
        ptrs = [tree_leaves(c.args[0])[0].data_ptr() for c in calls
                if c.func.__name__ == name]
        assert ptrs == sorted(set(ptrs)) and len(ptrs) == want.count(name)
    with torch.no_grad():
        calls.clear()
        get_model(cfg.replace(remat=True)).loss_fn(params,
                                                   port_batch(r["batch"]))
        assert calls == []
    if arch == "xlstm-1.3b":
        # two sLSTM blocks a forward, four forwards; never checkpointed
        assert inside == [False] * 8


# --------------------------------------------------- graph shape --

def consumers(root):
    """{id(node): [type names of the nodes that feed their gradient into
    it]} over the graph under ``root``, and {id(leaf): [the same for its
    AccumulateGrad]}."""
    into, leaf_users = {}, {}
    seen, todo = set(), [root]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if nxt is None:
                continue
            into.setdefault(nxt, []).append(node)
            if type(nxt).__name__ == "AccumulateGrad":
                leaf_users.setdefault(id(nxt.variable), []).append(node)
            todo.append(nxt)
    return into, leaf_users


@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_leaves_get_one_gradient_stack(runs, arch):
    """Each stacked leaf reaches the graph through one ``unbind`` (xLSTM's
    ``[groups, per_group, ...]`` stacks through a view, then one
    ``unbind``): one gradient of the whole stack comes back, not one a
    layer."""
    r = runs[arch, "float32"]
    params = from_numpy_tree(r["params"])
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss, _ = get_model(r["tcfg"].replace(remat=True)).loss_fn(
        params, port_batch(r["batch"]))
    into, users = consumers(loss.grad_fn)
    n = 0
    for key in STACKS[arch]:
        nested = key == "mblocks"
        for leaf in tree_leaves(params[key]):
            node, = users[id(leaf)]
            if nested:
                assert type(node).__name__ == "ViewBackward0"
                node, = into[node]
            assert type(node).__name__ == "UnbindBackward0", key
            n += 1
    assert n == sum(len(tree_leaves(params[k])) for k in STACKS[arch])


def test_slstm_steps_unbind_once():
    """The sLSTM's T steps take their inputs from one ``unbind`` of the
    input projection: no per-step select or slice of ``[B, T, 4d]``
    (each would send back a zero gradient the size of the sequence)."""
    _, cfg = configs("xlstm-1.3b", dtype="float32")
    sp = TX.slstm_block_init(torch.Generator().manual_seed(0), cfg)
    for p in tree_leaves(sp):
        p.requires_grad_(True)
    x = torch.randn(B, T, 64, generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    y, _ = TX.slstm_block_apply(sp, cfg, x)
    into, _ = consumers(y.grad_fn)
    kinds = [type(n).__name__ for n in into]
    unbinds = [n for n in into if type(n).__name__ == "UnbindBackward0"]
    assert len(unbinds) == 1 and unbinds[0]._saved_dim == 1
    assert len(into[unbinds[0]]) == T        # one step's input each
    big = [n for n in into if type(n).__name__ in ("SelectBackward0",
                                                   "SliceBackward0")
           and tuple(n._saved_self_sym_sizes) == (B, T, 4 * 64)]
    assert big == [] and "CopySlices" not in kinds


# ----------------------------------------------------- the step --

@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax_parts(runs, arch):
    """``build_train_step`` (AdamW) against JAX's ``clip_by_global_norm``,
    ``cosine_lr`` and ``adamw_update`` composed on JAX's gradients; each
    element within ``lr`` times the two packages' first-step difference
    plus 1e-6 of its value and of ``lr`` (``tests/test_torch_lm_train.py``
    sets out why)."""
    r = runs[arch, "float32"]
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
    train_step, init_opt = tsteps.build_train_step(
        get_model(r["tcfg"].replace(remat=True)), tc)
    params = from_numpy_tree(r["params"])
    got, opt, m = train_step(params, init_opt(params),
                             port_batch(r["batch"]), step)
    np.testing.assert_allclose(float(m["grad_norm"]), float(gnorm),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["loss"]), r["jax"]["loss"],
                               rtol=1e-6)
    assert set(m) == {"loss", "ce", "moe_aux", "grad_norm", "lr"}
    assert int(opt["count"]) == int(want_opt["count"]) == 1
    want, got = flat(want), flat(got)
    jg, tg = r["jax"]["grads"], r["remat_True"]["grads"]
    lr, eps = float(lr), 1e-8

    def first_step(g, norm):
        g = g * min(1.0, 1.0 / (norm + 1e-9))
        return g / (np.abs(g) + eps)
    for path, w in want.items():
        s_j = first_step(jg[path], float(gnorm))
        s_t = first_step(tg[path], float(m["grad_norm"]))
        allowed = lr * np.abs(s_t - s_j) + 1e-6 * np.abs(w) + 1e-6 * lr
        err = np.abs(got[path] - w)
        assert np.all(err <= allowed), (path, float(err.max()))


def test_microbatched_step_averages_the_gradients(runs):
    """``build_accumulating_step`` over two microbatches of Whisper's
    frames batch: the mean of the two halves' gradients."""
    r = runs["whisper-tiny", "float32"]
    tc = TrainConfig(optimizer="adamw", lr=3e-4, steps=10, batch_size=B,
                     microbatch=1)
    api = get_model(r["tcfg"])
    params = from_numpy_tree(r["params"])
    batch = port_batch(r["batch"])
    seen = []
    orig = tloop.value_and_grad

    def spy(loss_fn, p, mb):
        out = orig(loss_fn, p, mb)
        seen.append((mb["frames"].shape[0], out[1]))
        return out
    tloop.value_and_grad = spy
    try:
        step, init_opt = tloop.build_accumulating_step(api, tc)
        _, _, m = step(params, init_opt(params), batch, 0)
    finally:
        tloop.value_and_grad = orig
    assert [b for b, _ in seen] == [1, 1]
    (_, full) = orig(api.loss_fn, params, batch)
    mean = [(a + b) / 2 for a, b in zip(tree_leaves(seen[0][1]),
                                        tree_leaves(seen[1][1]))]
    for a, b in zip(mean, tree_leaves(full)):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-6 * float(b.abs().max()))
    assert np.isfinite(float(m["grad_norm"]))


# ------------------------------------------------ fit and launch --

@pytest.mark.parametrize("arch", ["xlstm-1.3b", "hymba-1.5b"])
def test_launch_train_runs_and_resumes(arch, tmp_path, capsys):
    """``launch.train --smoke --device cpu``: five steps straight, then the
    same command again after a crash that lost the checkpoints of steps 4
    and 5; it resumes at step 3 and ends bitwise where the straight run
    did (xLSTM's nested ``[groups, per_group]`` stacks included)."""
    argv = ["--arch", arch, "--smoke", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--ckpt-dir", str(tmp_path), "--steps", "5"]
    straight = tlaunch.main(argv)
    out = capsys.readouterr().out
    assert "done: loss" in out and "(step 4)" in out
    assert tckpt.latest_step(str(tmp_path)) == 5
    for d in (tmp_path, tmp_path / "opt"):
        for step in (4, 5):
            sub = d / f"step_{step:08d}"
            for f in sub.iterdir():
                f.unlink()
            sub.rmdir()
    resumed = tlaunch.main(argv)
    out = capsys.readouterr().out
    assert "(step 3)" in out and "(step 4)" in out and "(step 0)" not in out
    for (p, a), (_, b) in zip(leaves_with_paths(straight["params"]),
                              leaves_with_paths(resumed["params"])):
        assert torch.equal(a, b), p
    if arch == "xlstm-1.3b":
        assert straight["params"]["mblocks"]["wq"]["w"].shape[:2] == (2, 1)


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "hymba-1.5b"])
def test_fit_lowers_the_loss(arch, tmp_path, capsys):
    """``fit(get_model(cfg), tc, data)`` on the synthetic stream, remat on:
    the loss falls over 12 AdamW steps."""
    from repro_torch.data import lm_data
    cfg = get_smoke_config(arch).replace(remat=True)
    tc = TrainConfig(optimizer="adamw", lr=3e-3, lr_min=3e-4, steps=12,
                     batch_size=4, checkpoint_every=0,
                     checkpoint_dir=str(tmp_path))
    losses = []
    tloop.fit(get_model(cfg), tc,
              lambda s: lm_data.stream(0, 4, 32, cfg.vocab_size, s,
                                       device="cpu"),
              hooks={"on_step": lambda s, p, m: losses.append(
                  float(m["loss"]))}, device="cpu")
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < losses[0] - 0.3, losses
    capsys.readouterr()


def frames_stream(cfg, b, t, start):
    """Whisper batches: stub frames, tokens and labels drawn from numpy,
    a pure function of the step."""
    step = start
    while True:
        yield port_batch(draw_batch(cfg, seed=100 + step, b=b, t=t))
        step += 1


def test_fit_trains_whisper_on_frames(tmp_path, capsys):
    """``fit`` takes Whisper with any iterator whose batches carry
    ``"frames"``: finite losses that fall (the labels repeat, so the
    model can learn them), and a resume that ends bitwise."""
    cfg = get_smoke_config("whisper-tiny").replace(remat=True)
    losses = []

    def data(start):
        batch = port_batch(draw_batch(cfg, seed=5, b=4, t=16))
        while True:
            yield batch

    def tc(steps, every, sub):
        return TrainConfig(optimizer="adamw", lr=3e-3, lr_min=3e-4,
                           steps=steps, batch_size=4,
                           checkpoint_every=every,
                           checkpoint_dir=str(tmp_path / sub))
    straight = tloop.fit(get_model(cfg), tc(8, 4, "a"), data,
                         hooks={"on_step": lambda s, p, m: losses.append(
                             float(m["loss"]))}, device="cpu")
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.3, losses
    # a crash that lost step 8's checkpoints: the rerun resumes at 4
    for d in (tmp_path / "a", tmp_path / "a" / "opt"):
        sub = d / "step_00000008"
        for f in sub.iterdir():
            f.unlink()
        sub.rmdir()
    resumed = tloop.fit(get_model(cfg), tc(8, 4, "a"), data,
                        hooks={"on_step": lambda s, p, m: losses.append(s)},
                        device="cpu")
    assert losses[8:] == [4, 5, 6, 7]
    for (p, a), (_, b) in zip(leaves_with_paths(straight["params"]),
                              leaves_with_paths(resumed["params"])):
        assert torch.equal(a, b), p
    capsys.readouterr()


def test_launch_refuses_whisper_before_the_device(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--device", "cpu"]):
        with pytest.raises(ValueError, match="carries no 'frames'.*fit"):
            tlaunch.main(["--arch", "whisper-tiny", "--smoke", "--steps",
                          "1", "--ckpt-dir", str(tmp_path)] + extra)
    assert tckpt.latest_step(str(tmp_path)) is None


@pytest.mark.parametrize("arch", ["hymba-1.5b", "whisper-tiny"])
def test_flash_refuses_a_gradient_and_serves_without(arch):
    """On ``attn_impl="flash"`` the loss under grad raises flash's "no
    backward" error, remat on or off; the forward without a gradient
    serves as the xla route does."""
    cfg = get_smoke_config(arch).replace(attn_impl="flash")
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    batch = port_batch(draw_batch(cfg))
    for remat in (True, False):
        with pytest.raises(NotImplementedError,
                           match="no backward.*attn_impl='xla'"):
            tloop.value_and_grad(get_model(cfg.replace(
                remat=remat)).loss_fn, params, batch)
    inp = batch if cfg.family == "audio" else batch["tokens"]
    with torch.no_grad():
        served, _ = api.forward(params, inp)
    plain, _ = get_model(cfg.replace(attn_impl="xla")).forward(params, inp)
    torch.testing.assert_close(served, plain, rtol=0,
                               atol=4e-2 * float(plain.abs().max()))
