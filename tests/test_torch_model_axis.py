"""A ``model`` axis over processes, against ``repro`` on forced host devices.

The port's ranks hold their blocks of every parameter, optimizer leaf
and KV cache (``sharding.rules.place`` by ``params_shardings`` and
``cache_shardings``) and compute JAX's function: tensor parallelism for
the decoders (``models/{layers,attention,transformer}.py``), expert
parallelism and ``moe_apply_local`` for the MoE (``models/moe.py``), the
``fsdp`` profile (blocks gathered where a layer uses them, gradients
reduce-scattered), and the training loop's reductions, clip and
checkpoints (``train/{train_loop,optimizer}.py``).

Ranks: gloo processes on the CPU, one spawn a world for the module, each
a fresh interpreter running this file as a script (no JAX import),
meeting through a ``FileStore``: four ranks as ``(data=2, model=2)``
(and ``(data=4,)``), two as ``(data=1, model=2)``.  JAX runs in one
subprocess with ``--xla_force_host_platform_device_count=4`` on
``Mesh(devices.reshape(2, 2), ("data", "model"))`` (``jax.make_mesh``
makes Explicit axes in jax 0.9.0, where the embedding gather raises),
its steps composed from JAX's parts and jitted with ``params_shardings``
as in-shardings (JAX's own ``constrain_batch`` fails under 0.9.0).
Inputs and weights come from ``np.random.default_rng``; the weights
cross to the port through ``convert.from_numpy_tree``, then
``rules.place``.

Smoke configs in f32; tolerances: rtol 1e-5 and atol 1e-5 of each
leaf's (or the logits') max|x| (float32 sums in another order, XLA's
partitioned against the port's collectives).  Parameters after AdamW
steps also allow the difference that the two packages' gradient errors
make in an Adam step (``lr * |d_port - d_jax|``, with ``d`` each
package's Adam direction), as ``tests/test_torch_dp_train.py`` does.

* (i) tinyllama ``default`` on (2, 2): loss, gathered gradients, params
  after two steps; each rank's param and optimizer bytes equal
  ``rules.shard_bytes``; ranks holding the same block agree bitwise.
* (ii) the same under ``fsdp`` on (2, 2) and on (data=4).
* (iii) ``default`` prefill plus 4 decode steps on (1, 2): logits and
  the gathered cache; and, with one kv head (``H`` divides over
  ``model``, ``Hkv`` does not: ``wk``/``wv`` and the cache stay whole),
  the forward and a gradient against the port's one process.
* (iv) moonshot ``moe_local`` on (2, 2) at ``capacity_factor`` 0.5: the
  forward, ``aux`` and a step against JAX's ``moe_apply_local``, and the
  global route's logits differ beyond the tolerance, so the local route
  ran.
* (v) moonshot ``default`` (expert parallel) on (1, 2).
* The attention's uneven splits on (data=1, model=4): six query heads
  (``H`` does not divide, ``H * D`` does: every rank gathers every head
  and feeds ``wo`` its column block) and one kv head of width 6 (``Hkv *
  D`` does not divide: ``wk``/``wv`` whole on every rank), against JAX's
  jitted forward and gradients under ``params_shardings``.
* (vi) the refusals that stay, on real process meshes (the serve
  profiles ``infer2d``, ``cache_seq`` and ``fsdp`` over ``model`` are
  ``tests/test_torch_serve_axis.py``'s, the xLSTM, Hymba and Whisper serve
  steps ``tests/test_torch_family_serve_axis.py``'s), and
  ``seq_parallel``'s forward there, bitwise ``default``'s.
* (vii) ``launch.train --profile fsdp`` under ``torch.distributed.run
  --nproc-per-node 2 --device cpu`` resumes bitwise; ``--production-mesh``
  with 2 ranks raises.
"""
import os
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.convert import from_numpy_tree
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as tsteps
from repro_torch.models.api import get_model
from repro_torch.sharding import rules
from repro_torch.sharding.context import use_mesh, use_placement
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import train_loop as tloop
from repro_torch.tree import leaves_with_paths

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
DENSE, MOE = "tinyllama-1.1b", "moonshot-v1-16b-a3b"
GB, T = 8, 16                           # global batch, sequence
LR = 3e-4
STEP = 3                                # the schedule step of step one
CF = 0.5                                # moonshot's capacity factor (drops)
PROMPT, DECODE, MAX_LEN = 12, 4, 16
RTOL = 1e-5
TRAIN = {"default22": ("default", (("data", 2), ("model", 2))),
         "fsdp22": ("fsdp", (("data", 2), ("model", 2))),
         "replicated22": ("replicated", (("data", 2), ("model", 2))),
         "fsdp4": ("fsdp", (("data", 4),))}
# the attention's uneven splits over model=4 (the smoke d_model is 64)
UNEVEN = {"h6": dict(n_heads=6, n_kv_heads=2, head_dim=16),
          "kv6": dict(n_heads=4, n_kv_heads=1, head_dim=6)}


def _tc():
    return TrainConfig(optimizer="adamw", lr=LR, lr_min=LR / 10, steps=10,
                       batch_size=GB)


def _cfgs():
    dense = get_smoke_config(DENSE).replace(dtype="float32")
    moe = get_smoke_config(MOE).replace(dtype="float32",
                                        capacity_factor=CF)
    return {"dense": dense, "mqa": dense.replace(n_kv_heads=1),
            "moe_local": moe.replace(sharding_profile="moe_local"),
            "moe": moe, **{k: dense.replace(**v) for k, v in UNEVEN.items()}}


def _flat(tree):
    return {"/".join(map(str, p)): v.detach().numpy()
            for p, v in leaves_with_paths(tree)}


def _nest(flat):
    tree = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _batch(inp, name, i=0):
    return {"tokens": inp[name + "_toks"][i].long(),
            "labels": inp[name + "_labels"][i].long()}


# --------------------------------------------------------- the ranks --

def _train_case(api, params, inp, mesh, profile, name="dense"):
    """Two steps of ``build_accumulating_step`` on this rank's blocks,
    with the first step's reduced gradients: everything gathered whole,
    and the rank's own blocks and bytes."""
    step, init_opt = tloop.build_accumulating_step(api, _tc(), mesh, profile)
    pl = step.placement(mesh)
    local = rules.place(params, pl.params) if pl.params else params
    opt = init_opt(local)
    whole = rules.gather if pl.params else (lambda t, s: t)
    b0, b1 = _batch(inp, name, 0), _batch(inp, name, 1)

    def grads(params, b):
        with use_placement(pl):
            _, g = tloop.value_and_grad(api.loss_fn, params, {
                k: rules.constrain_batch(v, mesh, profile)
                for k, v in b.items()})
        return whole(tloop.group_mean(g, mesh, pl), pl.params)
    p1, o1, m1 = step(local, opt, b0, STEP)
    p2, o2, m2 = step(p1, o1, b1, STEP + 1)
    out = {"grads": grads(local, b0), "grads2": grads(p1, b1),
           "p1": whole(p1, pl.params),
           "p2": whole(p2, pl.params), "m1": m1, "m2": m2,
           "blocks": p2, "coords": {a: mesh.coordinate(a)
                                    for a in mesh.axis_names}}
    if pl.params:
        out["bytes"] = (sum(x.numel() * x.element_size()
                            for _, x in leaves_with_paths(local)),
                        rules.shard_bytes(params, pl.params),
                        sum(x.numel() * x.element_size()
                            for _, x in leaves_with_paths(o2)),
                        rules.shard_bytes(init_opt(params), pl.opt))
    return out


def _raises(fn):
    try:
        fn()
    except (NotImplementedError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def _refusals(inp, mesh):
    """(vi) on a real (data=2, model=2) mesh: each message."""
    cfgs = _cfgs()
    dense = get_model(cfgs["dense"])
    params = from_numpy_tree(inp["params"]["dense"])
    b0 = _batch(inp, "dense")
    out = {}
    out["moe_global"] = _raises(lambda: tloop.build_accumulating_step(
        get_model(cfgs["moe"]), _tc(), mesh))
    xlstm = get_model(get_smoke_config("xlstm-1.3b"))
    xlstm_params = xlstm.init(torch.Generator().manual_seed(0),
                              device="cpu")
    with use_mesh(mesh):
        out["xlstm"] = _raises(lambda: tsteps.build_prefill_step(xlstm)(
            rules.place(xlstm_params, rules.params_shardings(
                xlstm_params, mesh)), {"tokens": b0["tokens"]},
            xlstm.init_cache(GB, T, device="cpu")))
        rolling = get_model(cfgs["dense"].replace(sliding_window=T // 2))
        cache = rolling.init_cache(GB, T, device="cpu")
        cache = rules.place(cache, rules.cache_shardings(cache, mesh,
                                                         "cache_seq"))
        local = rules.place(params, rules.params_shardings(params, mesh,
                                                           "cache_seq"))
        out["rolling_cache_seq"] = _raises(
            lambda: tsteps.build_prefill_step(rolling, "cache_seq")(
                local, {"tokens": b0["tokens"]}, cache))
        # seq_parallel moves values since: the forward on the placed
        # blocks is default's bit for bit
        local = rules.place(params, rules.params_shardings(params, mesh))
        sp = get_model(cfgs["dense"].replace(seq_parallel=True))
        out["seq_parallel_bitwise"] = torch.equal(
            sp.forward(local, b0["tokens"])[0],
            dense.forward(local, b0["tokens"])[0])
    return out


def _serve_case(api, params, inp, mesh, name):
    """(iii): prefill and DECODE steps through the step builders on this
    rank's blocks and cache block; logits, the gathered cache."""
    cfg = api.cfg
    sh = rules.params_shardings(params, mesh)
    local = rules.place(params, sh)
    toks = inp[name + "_toks"][0]
    cache = api.init_cache(toks.shape[0], MAX_LEN, device="cpu")
    csh = rules.cache_shardings(cache, mesh)
    cache = rules.place(cache, csh)
    logits = []
    with use_mesh(mesh):
        lg, cache = tsteps.build_prefill_step(api)(
            local, {"tokens": toks[:, :PROMPT].long()}, cache)
        logits.append(lg)
        decode = tsteps.build_decode_step(api)
        for i in range(DECODE):
            lg, cache = decode(local, {"token": toks[:, PROMPT + i].long(),
                                       "pos": PROMPT + i}, cache)
            logits.append(lg)
    assert cfg.n_layers == cache["k"].shape[0]
    return {"logits": logits, "cache": rules.gather(cache, csh),
            "cache_block": tuple(cache["k"].shape)}


def _forward_grad_case(api, params, inp, mesh, name, profile="default"):
    """Forward logits and aux, the loss and its gathered gradients."""
    step, _ = tloop.build_accumulating_step(api, _tc(), mesh, profile)
    pl = step.placement(mesh)
    local = rules.place(params, pl.params)
    b0 = {k: rules.constrain_batch(v, mesh, profile)
          for k, v in _batch(inp, name).items()}
    with use_placement(pl):
        logits, aux = api.forward(local, b0["tokens"])
        (loss, _), g = tloop.value_and_grad(api.loss_fn, local, b0)
    g = tloop.group_mean(g, mesh, pl)
    return {"logits": logits.detach(), "aux": float(aux),
            "loss": float(tloop._metrics_mean({"loss": loss}, mesh,
                                              pl)["loss"]),
            "grads": rules.gather(g, pl.params),
            "attn_blocks": {k: tuple(local["blocks"]["attn"][k]["w"].shape)
                            for k in ("wq", "wk", "wo")}}


def _fit_case(work, mesh):
    """``fit(mesh=)`` on (2, 2): 3 steps with a checkpoint a step, then the
    same run after a crash that lost step 3's checkpoints; the whole
    params of both, and the leaf shapes step 3's manifest holds."""
    import json

    from repro_torch.data import lm_data
    api = get_model(_cfgs()["dense"])
    d = work / "fit"
    tc = TrainConfig(optimizer="adamw", lr=LR, lr_min=LR / 10, steps=3,
                     batch_size=GB, checkpoint_every=1, checkpoint_dir=str(d))

    def data(start):
        return lm_data.stream(seed=1, batch=GB, seq_len=T,
                              vocab=api.cfg.vocab_size, start_step=start,
                              device="cpu")
    pl = tloop.placement(api, mesh, init_opt=None)
    straight = tloop.fit(api, tc, data, log_every=1, device="cpu",
                         mesh=mesh)
    fit_whole = rules.gather(straight["params"], pl.params)
    manifest = json.loads((d / "step_00000003" / "manifest.json").read_text())
    kept = {k: tuple(v["shape"]) for k, v in manifest["leaves"].items()}
    torch.distributed.barrier()
    if torch.distributed.get_rank() == 0:
        for sub in (d, d / "opt"):
            shutil.rmtree(sub / "step_00000003")
    torch.distributed.barrier()
    resumed = tloop.fit(api, tc, data, log_every=1, device="cpu", mesh=mesh)
    return {"straight": fit_whole,
            "resumed": rules.gather(resumed["params"], pl.params),
            "steps": [h["step"] for h in resumed["history"]],
            "manifest_shapes": kept}


def _rank_main(work: pathlib.Path, world: str) -> None:
    torch.set_num_threads(1)
    dev = mesh_lib.init_distributed(
        "cpu", init_method=f"file://{work}/store_{world}")
    inp = torch.load(work / "inputs.pt", weights_only=False)   # numpy
    cfgs = _cfgs()
    out = {}
    if world == "four":
        meshes = {k: mesh_lib.make_group_mesh(axes, dev)
                  for k, (_, axes) in TRAIN.items() if k.endswith("4")}
        meshes["default22"] = mesh_lib.make_group_mesh(
            TRAIN["default22"][1], dev)
        meshes["fsdp22"] = meshes["replicated22"] = meshes["default22"]
        for key, (profile, _) in TRAIN.items():
            out[key] = _train_case(get_model(cfgs["dense"]),
                                   from_numpy_tree(inp["params"]["dense"]),
                                   inp, meshes[key], profile)
        m22 = meshes["default22"]
        api = get_model(cfgs["moe_local"])
        params = from_numpy_tree(inp["params"]["moe"])
        out["moe_local"] = _forward_grad_case(api, params, inp, m22, "moe")
        step, init_opt = tloop.build_accumulating_step(api, _tc(), m22)
        pl = step.placement(m22)
        local = rules.place(params, pl.params)
        p1, _, m1 = step(local, init_opt(local), _batch(inp, "moe"), STEP)
        out["moe_local"].update(p1=rules.gather(p1, pl.params), m1=m1)
        out["refusals"] = _refusals(inp, m22)
        m14 = mesh_lib.make_group_mesh((("data", 1), ("model", 4)), dev)
        for name in UNEVEN:
            out[name] = _forward_grad_case(
                get_model(cfgs[name]), from_numpy_tree(inp["params"][name]),
                inp, m14, name)
        out["fit"] = _fit_case(work, m22)
        out["rank"] = torch.distributed.get_rank()
    else:
        m12 = mesh_lib.make_group_mesh((("data", 1), ("model", 2)), dev)
        for name in ("dense", "mqa"):
            out[f"serve_{name}"] = _serve_case(
                get_model(cfgs[name]), from_numpy_tree(inp["params"][name]),
                inp, m12, name)
        from repro_torch.models import layers as TL
        emb = {"table": torch.from_numpy(inp["params"]["dense"]["embed"]
                                         ["table"])}
        ids = inp["dense_toks"][0].long()
        with use_mesh(m12):
            out["embed_bitwise"] = torch.equal(TL.embedding_apply(
                rules.place(emb, rules.params_shardings(
                    {"embed": emb}, m12)["embed"]), ids,
                emb["table"].shape[0]), emb["table"][ids])
        out["mqa"] = _forward_grad_case(
            get_model(cfgs["mqa"]), from_numpy_tree(inp["params"]["mqa"]),
            inp, m12, "mqa")
        out["moe_ep"] = _forward_grad_case(
            get_model(cfgs["moe"]), from_numpy_tree(inp["params"]["moe"]),
            inp, m12, "moe")
        out["rank"] = torch.distributed.get_rank()
    torch.save(out, work / f"{world}{out['rank']}.pt")
    torch.distributed.destroy_process_group()


# ------------------------------------------------------- JAX's side --

JAX_REF = """
import functools, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.configs.base import TrainConfig
from repro.models.api import get_model
from repro.sharding import rules
from repro.sharding.context import set_mesh
from repro.train import optimizer as jopt

z = np.load(sys.argv[1])
STEP, LR, PROMPT, DECODE, MAX_LEN, CF = (int(z["step"]), float(z["lr"]),
    int(z["prompt"]), int(z["decode"]), int(z["max_len"]), float(z["cf"]))
devs = np.array(jax.devices())
meshes = {"m22": Mesh(devs.reshape(2, 2), ("data", "model")),
          "m4": Mesh(devs.reshape(4), ("data",)),
          "m12": Mesh(devs[:2].reshape(1, 2), ("data", "model")),
          "m14": Mesh(devs.reshape(1, 4), ("data", "model"))}
UNEVEN = {"h6": dict(n_heads=6, n_kv_heads=2, head_dim=16),
          "kv6": dict(n_heads=4, n_kv_heads=1, head_dim=6)}
tc = TrainConfig(optimizer="adamw", lr=LR, lr_min=LR / 10, steps=10)
out = {}

def tree(prefix):
    t = {}
    for k in z.files:
        if k.startswith(prefix + ":"):
            *head, last = k[len(prefix) + 1:].split("/")
            node = t
            for h in head:
                node = node.setdefault(h, {})
            node[last] = jnp.asarray(z[k])
    return t

def put(prefix, t):
    for p, v in jax.tree_util.tree_flatten_with_path(t)[0]:
        out[prefix + ":" + "/".join(k.key for k in p)] = np.asarray(v)

def cfg_of(name):
    base = get_smoke_config("moonshot-v1-16b-a3b" if name.startswith("moe")
                            else "tinyllama-1.1b").replace(dtype="float32")
    if name == "mqa":
        return base.replace(n_kv_heads=1)
    if name in UNEVEN:
        return base.replace(**UNEVEN[name])
    if name.startswith("moe"):
        base = base.replace(capacity_factor=CF)
    return base.replace(sharding_profile="moe_local") \\
        if name == "moe_local" else base

def batch(name, i):
    name = name.replace("moe_local", "moe")
    return {"tokens": jnp.asarray(z[name + "_toks"][i]),
            "labels": jnp.asarray(z[name + "_labels"][i])}

def train(key, name, mesh, profile, n_steps):
    api = get_model(cfg_of(name))
    params = tree("p_" + name.replace("moe_local", "moe"))
    init, upd = jopt.get_optimizer(tc)
    opt = init(params)
    psh = rules.params_shardings(params, mesh, profile)
    osh = rules.params_shardings(opt, mesh, profile)
    bsh = rules.batch_shardings(batch(name, 0), mesh, profile)

    @functools.partial(jax.jit, in_shardings=(psh, osh, bsh, None))
    def step(params, opt, b, s):
        (_, metrics), grads = jax.value_and_grad(api.loss_fn, has_aux=True)(
            params, b)
        clipped, gnorm = jopt.clip_by_global_norm(grads, 1.0)
        lr = jopt.cosine_lr(s, tc)
        new, opt = upd(clipped, opt, params, lr, tc)
        return metrics, grads, gnorm, new, opt
    for i in range(n_steps):
        m, g, n, params, opt = step(params, opt, batch(name, i),
                                    jnp.asarray(STEP + i, jnp.int32))
        out[f"{key}:loss{i}"] = np.asarray(m["loss"])
        out[f"{key}:gnorm{i}"] = np.asarray(n)
        put(f"{key}_g{i}", g)
        put(f"{key}_p{i + 1}", params)

def forward(key, name, mesh):
    api = get_model(cfg_of(name))
    params = tree("p_" + name.replace("moe_local", "moe"))
    psh = rules.params_shardings(params, mesh)
    b = batch(name, 0)
    bsh = rules.batch_shardings(b, mesh)
    logits, aux = jax.jit(api.forward, in_shardings=(
        psh, bsh["tokens"]))(params, b["tokens"])
    (loss, _), g = jax.jit(jax.value_and_grad(api.loss_fn, has_aux=True),
                           in_shardings=(psh, bsh))(params, b)
    out[key + ":logits"] = np.asarray(logits)
    out[key + ":aux"] = np.asarray(aux)
    out[key + ":loss"] = np.asarray(loss)
    put(key + "_g", g)

def serve(key, name, mesh):
    api = get_model(cfg_of(name))
    params = tree("p_" + name)
    psh = rules.params_shardings(params, mesh)
    toks = jnp.asarray(z[name + "_toks"][0])
    cache = api.init_cache(toks.shape[0], MAX_LEN)
    csh = rules.cache_shardings(cache, mesh)
    prefill = jax.jit(api.prefill, in_shardings=(psh, None, csh))
    decode = jax.jit(api.decode_step, in_shardings=(psh, None, csh))
    lg, cache = prefill(params, {"tokens": toks[:, :PROMPT]}, cache)
    out[key + ":logits0"] = np.asarray(lg)
    for i in range(DECODE):
        lg, cache = decode(params, {"token": toks[:, PROMPT + i],
                                    "pos": jnp.asarray(PROMPT + i,
                                                       jnp.int32)}, cache)
        out[f"{key}:logits{i + 1}"] = np.asarray(lg)
    put(key + "_cache", cache)

part = sys.argv[3]
if part == "dense":
    train("default22", "dense", meshes["m22"], "default", 2)
    train("fsdp22", "dense", meshes["m22"], "fsdp", 2)
    train("fsdp4", "dense", meshes["m4"], "fsdp", 2)
    train("replicated22", "dense", meshes["m22"], "replicated", 2)
    serve("serve_dense", "dense", meshes["m12"])
else:
    forward("moe_ep", "moe", meshes["m12"])
    for name in UNEVEN:
        forward(name, name, meshes["m14"])
    set_mesh(meshes["m22"])
    forward("moe_local", "moe_local", meshes["m22"])
    train("moe_local", "moe_local", meshes["m22"], "default", 1)
    set_mesh(None)
np.savez(sys.argv[2], **out)
"""


def _np_params(cfg, rng):
    """Weights from ``rng`` with the init's tree, shapes and dtypes: N(0,
    1/fan_in) matrices (the embedding 0.02), norm gains near 1."""
    shapes = get_model(cfg).init(torch.Generator(), device="cpu")
    out = {}
    for path, t in leaves_with_paths(shapes):
        shape = tuple(t.shape)
        if path[-1] == "g":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            std = 0.02 if path[-1] == "table" else shape[-2] ** -0.5
            v = std * rng.standard_normal(shape)
        out["/".join(map(str, path))] = v.astype(np.float32)
    return out


def _spawn(work, world, n):
    env = dict(os.environ, PYTHONPATH=str(SRC), WORLD_SIZE=str(n),
               OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, __file__, str(work), world],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]


def _join(proc, what, timeout=240):
    out, _ = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, f"{what} failed:\n{out}"
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Inputs drawn; the six ranks and JAX's two reference processes run
    at once; the port's one-process references computed meanwhile."""
    work = tmp_path_factory.mktemp("model_axis")
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    cfgs = _cfgs()
    np_params = {name: _np_params(cfgs[name], rng)
                 for name in ("dense", "mqa", "moe")}
    arrays = {"step": STEP, "lr": LR, "prompt": PROMPT, "decode": DECODE,
              "max_len": MAX_LEN, "cf": CF}
    inp = {"params": {}}
    # the uneven cases draw from a stream of their own
    rng_uneven = np.random.default_rng(1)
    np_params.update({name: _np_params(cfgs[name], rng_uneven)
                      for name in UNEVEN})
    for name in ("dense", "mqa", "moe", *UNEVEN):
        draw = rng_uneven if name in UNEVEN else rng
        vocab = cfgs[name].vocab_size
        toks = draw.integers(0, vocab, (2, GB, T)).astype(np.int32)
        labels = draw.integers(0, vocab, (2, GB, T)).astype(np.int32)
        arrays.update({name + "_toks": toks, name + "_labels": labels,
                       **{f"p_{name}:{k}": v
                          for k, v in np_params[name].items()}})
        inp[name + "_toks"] = torch.from_numpy(toks)
        inp[name + "_labels"] = torch.from_numpy(labels)
        inp["params"][name] = _nest(np_params[name])
    np.savez(work / "jax_in.npz", **arrays)
    torch.save(inp, work / "inputs.pt")
    procs = _spawn(work, "four", 4) + _spawn(work, "two", 2)
    jax_env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    jax_procs = {part: subprocess.Popen(
        [sys.executable, "-c", JAX_REF, str(work / "jax_in.npz"),
         str(work / f"jax_{part}.npz"), part], env=jax_env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for part in ("dense", "moe")}

    # the port's one-process references
    port = {}
    for name in ("mqa", "moe"):
        api = get_model(cfgs[name])
        params = from_numpy_tree(inp["params"][name])
        b = _batch(inp, name)
        logits, aux = api.forward(params, b["tokens"])
        (loss, _), g = tloop.value_and_grad(api.loss_fn, params, b)
        port[name] = {"logits": logits.detach(), "aux": float(aux),
                      "loss": float(loss), "grads": g}
    for name in ("dense", "mqa"):
        api = get_model(cfgs[name])
        params = from_numpy_tree(inp["params"][name])
        toks = inp[name + "_toks"][0].long()
        cache = api.init_cache(GB, MAX_LEN, device="cpu")
        lg, cache = api.prefill(params, {"tokens": toks[:, :PROMPT]}, cache)
        seq = [lg]
        for i in range(DECODE):
            lg, cache = api.decode_step(params, {"token": toks[:, PROMPT + i],
                                                 "pos": PROMPT + i}, cache)
            seq.append(lg)
        port["serve_" + name] = {"logits": seq, "cache": cache}

    logs = [_join(p, f"rank {i}") for i, p in enumerate(procs)]
    for part, p in jax_procs.items():
        _join(p, f"JAX's {part} reference")
    jx = {}
    for part in ("dense", "moe"):
        with np.load(work / f"jax_{part}.npz") as z:
            jx.update({k: z[k] for k in z.files})
    four = [torch.load(work / f"four{r}.pt") for r in range(4)]
    two = [torch.load(work / f"two{r}.pt") for r in range(2)]
    print(f"model_axis fixture: {time.perf_counter() - t0:.1f} s")
    return dict(four=four, two=two, jax=jx, port=port, logs=logs,
                np_params=np_params)


# ------------------------------------------------------------ checks --

def _close(got, want, what, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=RTOL * scale,
                               err_msg=what)


def _jax_tree(jx, prefix):
    return {k[len(prefix) + 1:]: v for k, v in jx.items()
            if k.startswith(prefix + ":")}


def _adam(p0, grads, gnorms, lrs):
    """The packages' AdamW trajectory in float64 from their gradients."""
    b1, b2, eps, wd = 0.9, 0.95, 1e-8, _tc().weight_decay
    p, m, v = p0.astype(np.float64), 0.0, 0.0
    for i, (g, n, lr) in enumerate(zip(grads, gnorms, lrs)):
        g = g * min(1.0, 1.0 / (n + 1e-9))
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        d = (m / (1 - b1 ** (i + 1))) / (np.sqrt(v / (1 - b2 ** (i + 1)))
                                         + eps)
        p = p - lr * (d + wd * p)
    return p


def _check_params(got, jx, key, np_params, port_grads, jax_grads, gnorms,
                  lrs, n):
    """Params after ``n`` steps: rtol 1e-5 plus what the two packages'
    gradients change in the Adam trajectory."""
    want = _jax_tree(jx, f"{key}_p{n}")
    assert want.keys() == got.keys()
    for p, w in want.items():
        a_port = _adam(np_params[p], [g[p] for g in port_grads[:n]],
                       gnorms[0][:n], lrs[:n])
        a_jax = _adam(np_params[p], [g[p] for g in jax_grads[:n]],
                      gnorms[1][:n], lrs[:n])
        allowed = RTOL * np.abs(w) + np.abs(a_port - a_jax) + 1e-6 * LR
        err = np.abs(got[p] - w)
        assert np.all(err <= allowed), (key, p, float((err - allowed).max()))


@pytest.mark.parametrize("key", list(TRAIN))
def test_training_step_matches_jax(runs, key):
    """(i) and (ii): loss, gathered gradients and the params after two
    AdamW steps, on every rank, against JAX's step under the same
    placement."""
    jx, np_params = runs["jax"], runs["np_params"]["dense"]
    jg = [_jax_tree(jx, f"{key}_g{i}") for i in range(2)]
    for out in runs["four"]:
        r = out[key]
        for i, m in enumerate((r["m1"], r["m2"])):
            np.testing.assert_allclose(float(m["loss"]),
                                       float(jx[f"{key}:loss{i}"]),
                                       rtol=RTOL, err_msg=f"{key} loss {i}")
            np.testing.assert_allclose(float(m["grad_norm"]),
                                       float(jx[f"{key}:gnorm{i}"]),
                                       rtol=RTOL)
        grads = _flat(r["grads"])
        assert grads.keys() == jg[0].keys()
        for p, w in jg[0].items():
            _close(grads[p], w, f"{key} grad {p}")
        lrs = [float(r["m1"]["lr"]), float(r["m2"]["lr"])]
        gn = ([float(r["m1"]["grad_norm"]), float(r["m2"]["grad_norm"])],
              [float(jx[f"{key}:gnorm{i}"]) for i in range(2)])
        port_g = [grads, _flat(r["grads2"])]
        _check_params(_flat(r["p1"]), jx, key, np_params, port_g, jg, gn,
                      lrs, 1)
        _check_params(_flat(r["p2"]), jx, key, np_params, port_g, jg, gn,
                      lrs, 2)


@pytest.mark.parametrize("key", ["default22", "fsdp22"])
def test_each_rank_holds_its_blocks(runs, key):
    """Each rank's param and AdamW bytes equal ``rules.shard_bytes``, and
    ranks holding the same block hold the same bits after two steps."""
    outs = [o[key] for o in runs["four"]]
    for r in outs:
        got_p, want_p, got_o, want_o = r["bytes"]
        assert got_p == want_p and got_o == want_o, r["bytes"]
        assert got_p < sum(v.nbytes for v in
                           runs["np_params"]["dense"].values())
    specs = {"/".join(map(str, p)): sh.spec for p, sh in leaves_with_paths(
        rules.params_shardings(_nest(runs["np_params"]["dense"]),
                               mesh_lib.Mesh(("data", "model"), (2, 2)),
                               TRAIN[key][0]))}
    first = {r["coords"]["model"]: _flat(r["blocks"]) for r in outs}
    split = 0
    for r in outs:
        for p, v in _flat(r["blocks"]).items():
            if all(a is None for a in specs[p]):      # whole on every rank
                assert np.array_equal(v, first[0][p]), (key, p)
            elif key == "default22":                  # the model block's
                split += 1
                assert np.array_equal(v, first[r["coords"]["model"]][p]), \
                    (key, p)
            else:                                     # a block of its own
                split += 1
    assert split > 0


def test_fsdp_on_a_data_mesh_is_default_data_parallel(runs):
    """On (data=4) ``fsdp`` places every leaf whole (no ``model`` axis)
    and splits the batch over ``data``: the same step on every rank."""
    first = _flat(runs["four"][0]["fsdp4"]["p2"])
    for out in runs["four"]:
        assert "bytes" not in out["fsdp4"]
        for p, v in _flat(out["fsdp4"]["blocks"]).items():
            assert np.array_equal(v, first[p]), p


@pytest.mark.parametrize("name", ["dense", "mqa"])
def test_prefill_and_decode_on_a_model_axis(runs, name):
    """(iii) on (1, 2): prefill and DECODE steps; each step's logits and
    the gathered cache against JAX's (dense) or the port's one process
    (one kv head: ``wk``, ``wv`` and the cache stay whole)."""
    port = runs["port"]["serve_" + name]
    for out in runs["two"]:
        r = out["serve_" + name]
        for i, lg in enumerate(r["logits"]):
            want = runs["jax"][f"serve_dense:logits{i}"] if name == "dense" \
                else port["logits"][i].numpy()
            _close(lg.numpy(), want, f"{name} logits {i}")
            _close(lg.numpy(), port["logits"][i].numpy(),
                   f"{name} logits {i}, one process")
        for k in ("k", "v"):
            want = runs["jax"][f"serve_dense_cache:{k}"] if name == "dense" \
                else port["cache"][k].numpy()
            _close(r["cache"][k].numpy(), want, f"{name} cache {k}")
        # dense: Hkv 2 split over model; mqa: its one kv head whole
        assert r["cache_block"][3] == 1


def test_vocab_split_lookup_is_bitwise(runs):
    """The embedding's vocab blocks on (1, 2): each row comes from one
    rank, so the summed lookup is the whole table's bit for bit."""
    assert all(out["embed_bitwise"] for out in runs["two"])


def test_whole_kv_heads_train_on_a_model_axis(runs):
    """One kv head under 4 query heads on (1, 2): the forward, the loss
    and every gathered gradient leaf against the port's one process."""
    want = runs["port"]["mqa"]
    wg = _flat(want["grads"])
    for out in runs["two"]:
        r = out["mqa"]
        _close(r["logits"].numpy(), want["logits"].numpy(), "mqa logits")
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=RTOL)
        for p, g in _flat(r["grads"]).items():
            _close(g, wg[p], f"mqa grad {p}")


def test_moe_local_matches_jax_moe_apply_local(runs):
    """(iv) moonshot ``moe_local`` on (2, 2) at capacity factor 0.5: the
    ranks' logits (their data blocks, whole over ``model``), ``aux``,
    the loss, the gathered gradients and the params after one step
    against JAX's ``moe_apply_local``; the global route's logits differ
    beyond the tolerance, so the test shows the local route ran."""
    jx = runs["jax"]
    want = jx["moe_local:logits"]
    outs = runs["four"]
    by_data = {}
    for out in outs:
        by_data.setdefault(out["default22"]["coords"]["data"],
                           []).append(out["moe_local"])
    got = np.concatenate([by_data[d][0]["logits"].numpy()
                          for d in sorted(by_data)])
    _close(got, want, "moe_local logits")
    for same in by_data.values():
        assert np.array_equal(same[0]["logits"].numpy(),
                              same[1]["logits"].numpy())
    scale = float(np.abs(want).max())
    glob = runs["port"]["moe"]["logits"].numpy()
    assert float(np.abs(glob - want).max()) > 100 * RTOL * scale, \
        "the global route's logits are the local route's: nothing shows " \
        "which route ran"
    jg = _jax_tree(jx, "moe_local_g")
    jg0 = _jax_tree(jx, "moe_local_g0")
    for out in outs:
        r = out["moe_local"]
        np.testing.assert_allclose(r["aux"], float(jx["moe_local:aux"]),
                                   rtol=RTOL)
        np.testing.assert_allclose(r["loss"], float(jx["moe_local:loss"]),
                                   rtol=RTOL)
        grads = _flat(r["grads"])
        assert grads.keys() == jg.keys()
        for p, w in jg.items():
            _close(grads[p], w, f"moe_local grad {p}")
            _close(grads[p], jg0[p], f"moe_local step grad {p}")
        np.testing.assert_allclose(float(r["m1"]["loss"]),
                                   float(jx["moe_local:loss0"]), rtol=RTOL)
        gn = ([float(r["m1"]["grad_norm"])],
              [float(jx["moe_local:gnorm0"])])
        _check_params(_flat(r["p1"]), jx, "moe_local",
                      runs["np_params"]["moe"], [grads], [jg0], gn,
                      [float(r["m1"]["lr"])], 1)


@pytest.mark.parametrize("name", list(UNEVEN))
def test_uneven_attention_splits_match_jax(runs, name):
    """On (1, 4): ``h6`` (6 query heads of 16: ``wq`` a column block of
    24 that cuts a head, every rank gathering every head, ``wo`` fed its
    column block; ``wk``/``wv`` column blocks of 8 gathered) and ``kv6``
    (4 query heads and one kv head of 6: ``wq`` a head a rank, ``wk``/
    ``wv`` whole on every rank, their gradient summed over the group):
    logits, aux, loss and every gathered gradient leaf against JAX's
    jitted forward under ``params_shardings``, on every rank."""
    jx = runs["jax"]
    jg = _jax_tree(jx, name + "_g")
    cfg = _cfgs()[name]
    hd = cfg.kv_head_dim
    want_blocks = {"wq": (cfg.d_model, cfg.n_heads * hd // 4),
                   "wk": (cfg.d_model, cfg.n_kv_heads * hd //
                          (4 if name == "h6" else 1)),
                   "wo": (cfg.n_heads * hd // 4, cfg.d_model)}
    for out in runs["four"]:
        r = out[name]
        assert {k: v[-2:] for k, v in r["attn_blocks"].items()} == \
            want_blocks, r["attn_blocks"]
        _close(r["logits"].numpy(), jx[name + ":logits"], f"{name} logits")
        np.testing.assert_allclose(r["loss"], float(jx[name + ":loss"]),
                                   rtol=RTOL)
        np.testing.assert_allclose(r["aux"], float(jx[name + ":aux"]),
                                   rtol=RTOL, atol=1e-12)
        grads = _flat(r["grads"])
        assert grads.keys() == jg.keys()
        for p, w in jg.items():
            _close(grads[p], w, f"{name} grad {p}")


def test_moe_expert_parallel_matches_jax(runs):
    """(v) moonshot ``default`` on (1, 2): each rank holds 4 of the 8
    experts; logits, aux, loss and gradients against JAX's."""
    jx = runs["jax"]
    jg = _jax_tree(jx, "moe_ep_g")
    for out in runs["two"]:
        r = out["moe_ep"]
        _close(r["logits"].numpy(), jx["moe_ep:logits"], "moe_ep logits")
        np.testing.assert_allclose(r["aux"], float(jx["moe_ep:aux"]),
                                   rtol=RTOL)
        np.testing.assert_allclose(r["loss"], float(jx["moe_ep:loss"]),
                                   rtol=RTOL)
        grads = _flat(r["grads"])
        for p, w in jg.items():
            _close(grads[p], w, f"moe_ep grad {p}")


# what: (the error's kind, what it cites), or None where it serves now
REFUSED = {"moe_global": ("NotImplementedError", "Queue 3"),
           "xlstm": ("ValueError", "rules.place"),
           "rolling_cache_seq": None}


@pytest.mark.parametrize("what", list(REFUSED))
def test_refusals_that_stay(runs, what):
    """(vi) on a real (data=2, model=2) mesh: the global MoE route over
    two data ranks raises; an xLSTM serve step split over ``model`` with a
    cache made whole by hand (not placed by ``rules.place``, whose rules
    split its state) raises ``ValueError`` naming ``rules.place`` (the
    step itself serves: ``tests/test_torch_family_serve_axis.py``); and a
    rolling (sliding-window) cache split by position under ``cache_seq``,
    which raised before, serves (``infer2d``, ``cache_seq`` and ``fsdp``
    serve steps: ``tests/test_torch_serve_axis.py``)."""
    for out in runs["four"]:
        msg = out["refusals"][what]
        if REFUSED[what] is None:
            assert msg is None, (what, msg)
            continue
        kind, cite = REFUSED[what]
        assert msg is not None and msg.startswith(kind) and cite in msg, \
            (what, msg)


def test_seq_parallel_forward_is_default_bitwise(runs):
    """(vi) ``seq_parallel`` on a real (data=2, model=2) mesh, which it
    refused before: the forward on the placed blocks is ``default``'s
    bit for bit (``tests/test_torch_sp_axis.py`` holds it against
    JAX)."""
    assert all(out["refusals"]["seq_parallel_bitwise"]
               for out in runs["four"])


def test_fit_on_a_model_axis_resumes_bitwise(runs):
    """``fit(mesh=)`` on (2, 2) writes whole leaves (JAX's format) and a
    run resumed from step 2 ends bitwise where the straight run did."""
    whole = {k: tuple(v.shape) for k, v in runs["np_params"]["dense"].items()}
    for out in runs["four"]:
        r = out["fit"]
        assert r["steps"] == [2]
        assert r["manifest_shapes"] == whole
        got, want = _flat(r["resumed"]), _flat(r["straight"])
        for p, v in want.items():
            assert np.array_equal(got[p], v), p


def test_meshes_and_their_refusals(monkeypatch):
    """A group mesh needs a group of its size; the production mesh stays
    abstract without a group and raises at another world size."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.make_group_mesh((("data", 1), ("model", 2)), "cpu")
    prod = mesh_lib.make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16} and \
        prod.device_mesh is None
    x = torch.zeros(16, 3)
    with pytest.raises(ValueError, match="abstract"):
        rules.constrain_batch(x, prod)
    sh = rules.params_shardings({"w": {"up": {"w": x}}}, prod)
    assert sh["w"]["up"]["w"].spec == rules.P(None, None)
    sh = rules.params_shardings({"up": {"w": x.T}}, prod)
    with pytest.raises(ValueError, match="abstract"):
        rules.place({"up": {"w": x.T}}, sh)


# ------------------------------------------------- launch.train --

def _torchrun(args, check=True):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
           *args]
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=180)
    if check:
        assert proc.returncode == 0, f"{args}:\n{proc.stdout}\n{proc.stderr}"
    return proc


def test_launch_train_fsdp_resumes_and_production_mesh_raises(tmp_path):
    """(vii) ``--profile fsdp`` on two ranks: 3 steps, then the same
    command after a crash that lost step 3's checkpoints resumes bitwise;
    ``--production-mesh`` on two ranks raises ``ValueError``."""
    ckpt = tmp_path / "ckpt"
    argv = ["--arch", DENSE, "--smoke", "--device", "cpu", "--steps", "3",
            "--batch", "4", "--seq", "16", "--profile", "fsdp",
            "--ckpt-dir", str(ckpt)]
    prod = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         *argv[:-2], "--production-mesh", "--ckpt-dir",
         str(tmp_path / "prod")],
        env=dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = _torchrun(argv).stdout
    assert out.count("done: loss") == 1 and "(step 2)" in out
    kept = tmp_path / "step3"
    shutil.copytree(ckpt / "step_00000003", kept)
    for d in (ckpt, ckpt / "opt"):
        shutil.rmtree(d / "step_00000003")
    out = _torchrun(argv).stdout
    assert "(step 2)" in out and "(step 0)" not in out
    with np.load(kept / "shards_host0.npz") as a, \
            np.load(ckpt / "step_00000003" / "shards_host0.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
    log, _ = prod.communicate(timeout=180)
    assert prod.returncode != 0
    assert "ValueError: --production-mesh spans 256 devices" in log, log
    assert tckpt.latest_step(str(tmp_path / "prod")) is None


if __name__ == "__main__":
    _rank_main(pathlib.Path(sys.argv[1]), sys.argv[2])
