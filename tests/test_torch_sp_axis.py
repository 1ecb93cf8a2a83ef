"""``seq_parallel`` moving values over a ``model`` axis of processes,
against ``repro`` on forced host devices.

Under ``cfg.seq_parallel`` each rank's residual stream between blocks is
its block of the sequence (``models/transformer.py::seq_group``): the
norms run on it, attention and the MLP read it gathered whole, each
one's summed output is cut back to it (``collectives.split_to``), and
it is gathered whole before ``ln_f``.
JAX's ``_seq_parallel``/``_gather_seq`` constraints compute the same
function, so:

* (i) tinyllama f32 ``sp`` training step, remat on, on (2, 2) and
  (1, 4): logits and loss bitwise the port's ``default`` step on the
  same mesh (the all-reduce and the slice are ``default``'s sum), every
  gathered gradient bitwise but the norm gains' (their gradient is the
  sum of the ranks' blocks', rtol 1e-5); all against JAX's ``sp`` step
  at rtol 1e-5 of max|x|; each checkpointed layer input is the rank's
  ``[B, T / m, d]``; the norm gains are equal on every rank after an
  AdamW step and each rank's parameter bytes are ``rules.shard_bytes``.
* (ii) ``sp_chunked`` (``xla_chunked`` attention) against JAX's.
* (iii) moonshot ``moe_local_sp`` (``moe_local``, ``seq_parallel``,
  ``xla_chunked``) forward and aux against JAX's ``moe_apply_local``.
* (iv) prefill (an even prompt, which splits, and an odd one, which
  stays whole) and decode steps under ``sp``: the logits and the
  gathered cache bitwise ``default``'s.
* (v) ``sp`` under ``fsdp``: the rows already split over ``model``, the
  constraint moves nothing, the step bitwise ``fsdp``'s.
* (vi) a real tensor on an abstract mesh raises ``ValueError``.

Ranks: four gloo processes on the CPU, spawned once, this file run as a
script (no JAX import), meeting through a ``FileStore`` as ``(data=2,
model=2)`` and ``(data=1, model=4)``.  JAX runs once, in one subprocess
with ``--xla_force_host_platform_device_count=4``, on
``jax.sharding.Mesh(devices.reshape(2, 2), ("data", "model"))`` (never
``jax.make_mesh``): its steps composed from its parts, jitted with
``params_shardings`` as in-shardings and run under ``with mesh:`` (the
constraint takes a bare ``PartitionSpec``).  Weights and tokens come from
``np.random.default_rng``.
"""
import os
import pathlib
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
from repro_torch.launch.dryrun import apply_variant
from repro_torch.models import transformer as TT
from repro_torch.models.api import get_model
from repro_torch.sharding import rules
from repro_torch.sharding.context import use_mesh, use_placement
from repro_torch.train import train_loop as tloop
from repro_torch.tree import leaves_with_paths

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
DENSE, MOE = "tinyllama-1.1b", "moonshot-v1-16b-a3b"
GB, T = 8, 16                           # global batch, sequence
PROMPTS, DECODE, MAX_LEN = (12, 11), 4, 16
LR = 3e-4
RTOL = 1e-5
MESHES = {"m22": (("data", 2), ("model", 2)),
          "m14": (("data", 1), ("model", 4))}
NORMS = ("blocks/ln1/g", "blocks/ln2/g")


def _tc():
    return TrainConfig(optimizer="adamw", lr=LR, lr_min=LR / 10, steps=10,
                       batch_size=GB)


def _cfgs():
    dense = get_smoke_config(DENSE).replace(dtype="float32", remat=True)
    moe = get_smoke_config(MOE).replace(dtype="float32")
    return {"dense": dense, "sp": apply_variant(dense, "sp"),
            "sp_chunked": apply_variant(dense, "sp_chunked"),
            "moe_local_sp": apply_variant(moe, "moe_local_sp")}


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


def _nbytes(tree):
    return sum(x.numel() * x.element_size()
               for _, x in leaves_with_paths(tree))


def _batch(inp, name):
    return {"tokens": inp[name + "_toks"].long(),
            "labels": inp[name + "_labels"].long()}


# --------------------------------------------------------- the ranks --

def _step_case(inp, mesh, name, profile=None):
    """Forward logits, loss and gathered gradients of ``name``'s config
    under ``profile``, then one AdamW step: the leaves each rank holds
    after it, its bytes, and the shapes of the checkpointed layer
    inputs."""
    api = get_model(_cfgs()[name])
    params = from_numpy_tree(inp["params"]["moe" if "moe" in name
                                           else "dense"])
    step, init_opt = tloop.build_accumulating_step(api, _tc(), mesh, profile)
    pl = step.placement(mesh)
    local = rules.place(params, pl.params)
    whole = _batch(inp, "moe" if "moe" in name else "dense")
    b = {k: rules.constrain_batch(v, mesh, tloop._profile(api, profile))
         for k, v in whole.items()}
    saved = []
    real = TT.checkpointed

    def spy(layer, x, *rest):
        saved.append(tuple(x.shape))
        return real(layer, x, *rest)
    TT.checkpointed = spy
    try:
        with use_placement(pl):
            with torch.no_grad():
                logits, aux = api.forward(local, b["tokens"])
            (loss, _), g = tloop.value_and_grad(api.loss_fn, local, b)
    finally:
        TT.checkpointed = real
    out = {"logits": logits, "aux": float(aux),
           "loss": tloop._metrics_mean({"loss": loss}, mesh, pl)["loss"],
           "grads": rules.gather(tloop.group_mean(g, mesh, pl), pl.params),
           "saved": saved, "bytes": (_nbytes(local),
                                     rules.shard_bytes(params, pl.params))}
    if "moe" not in name:
        p1, _, m1 = step(local, init_opt(local), whole, 3)
        out["p1_blocks"] = _flat(p1)
        out["grad_norm"] = float(m1["grad_norm"])
    return out


def _serve_case(inp, mesh, name, prompt):
    """Prefill ``prompt`` tokens and DECODE steps through
    ``build_prefill_step`` and ``build_decode_step`` on this rank's
    blocks (rows over ``data``): each step's logits and the gathered
    cache."""
    api = get_model(_cfgs()[name].replace(remat=False))
    params = from_numpy_tree(inp["params"]["dense"])
    local = rules.place(params, rules.params_shardings(params, mesh))
    toks = inp["dense_toks"].long()
    cache = api.init_cache(GB, MAX_LEN, device="cpu")
    csh = rules.cache_shardings(cache, mesh)
    cache = rules.place(cache, csh)
    logits = []
    with use_mesh(mesh):
        lg, cache = tsteps.build_prefill_step(api)(
            local, {"tokens": toks[:, :prompt]}, cache)
        logits.append(lg)
        decode = tsteps.build_decode_step(api)
        for i in range(DECODE):
            lg, cache = decode(local, {"token": toks[:, prompt + i],
                                       "pos": prompt + i}, cache)
            logits.append(lg)
    return {"logits": logits, "cache": rules.gather(cache, csh)}


def _rank_main(work: pathlib.Path) -> None:
    torch.set_num_threads(1)
    dev = mesh_lib.init_distributed("cpu",
                                    init_method=f"file://{work}/store")
    inp = torch.load(work / "inputs.pt", weights_only=False)
    meshes = {k: mesh_lib.make_group_mesh(v, dev) for k, v in MESHES.items()}
    out = {"rank": torch.distributed.get_rank(),
           "coords": {a: meshes["m22"].coordinate(a)
                      for a in ("data", "model")}}
    for m in MESHES:
        out["default_" + m] = _step_case(inp, meshes[m], "dense")
        out["sp_" + m] = _step_case(inp, meshes[m], "sp")
    m22 = meshes["m22"]
    out["sp_chunked"] = _step_case(inp, m22, "sp_chunked")
    out["moe_local_sp"] = _step_case(inp, m22, "moe_local_sp")
    out["fsdp"] = _step_case(inp, m22, "dense", "fsdp")
    out["sp_fsdp"] = _step_case(inp, m22, "sp", "fsdp")
    for prompt in PROMPTS:
        for name in ("dense", "sp"):
            out[f"serve_{name}_{prompt}"] = _serve_case(inp, m22, name,
                                                        prompt)
    torch.save(out, work / f"rank{out['rank']}.pt")
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
devs = np.array(jax.devices())
meshes = {"m22": Mesh(devs.reshape(2, 2), ("data", "model")),
          "m14": Mesh(devs.reshape(1, 4), ("data", "model"))}
tc = TrainConfig(optimizer="adamw", lr=float(z["lr"]), steps=10)
dense = get_smoke_config("tinyllama-1.1b").replace(dtype="float32",
                                                    remat=True)
moe = get_smoke_config("moonshot-v1-16b-a3b").replace(dtype="float32")
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

def run(key, cfg, name, mesh):
    api = get_model(cfg)
    params = tree("p_" + name)
    b = {"tokens": jnp.asarray(z[name + "_toks"]),
         "labels": jnp.asarray(z[name + "_labels"])}
    psh = rules.params_shardings(params, mesh)
    bsh = rules.batch_shardings(b, mesh)
    with mesh:
        set_mesh(mesh)
        logits, aux = jax.jit(api.forward, in_shardings=(
            psh, bsh["tokens"]))(params, b["tokens"])
        out[key + ":logits"] = np.asarray(logits)
        out[key + ":aux"] = np.asarray(aux)
        if name == "dense":
            @functools.partial(jax.jit, in_shardings=(psh, bsh))
            def grads(params, b):
                (loss, _), g = jax.value_and_grad(api.loss_fn,
                                                  has_aux=True)(params, b)
                return loss, g, jopt.clip_by_global_norm(g, 1.0)[1]
            loss, g, gnorm = grads(params, b)
            out[key + ":loss"] = np.asarray(loss)
            out[key + ":gnorm"] = np.asarray(gnorm)
            put(key + "_g", g)
        set_mesh(None)

# the dry-run's variants (repro.launch.dryrun sets XLA_FLAGS on import)
sp = dict(seq_parallel=True)
chunked = dict(sp, attn_impl="xla_chunked")
run("sp_m22", dense.replace(**sp), "dense", meshes["m22"])
run("sp_m14", dense.replace(**sp), "dense", meshes["m14"])
run("sp_chunked", dense.replace(**chunked), "dense", meshes["m22"])
run("moe_local_sp", moe.replace(sharding_profile="moe_local", **chunked),
    "moe", meshes["m22"])
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Inputs drawn; the four ranks and JAX's reference run at once."""
    work = tmp_path_factory.mktemp("sp_axis")
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    cfgs = _cfgs()
    np_params = {"dense": _np_params(cfgs["dense"], rng),
                 "moe": _np_params(cfgs["moe_local_sp"], rng)}
    arrays = {"lr": LR}
    inp = {"params": {}}
    for name in ("dense", "moe"):
        vocab = cfgs["dense"].vocab_size
        toks = rng.integers(0, vocab, (GB, T)).astype(np.int32)
        labels = rng.integers(0, vocab, (GB, T)).astype(np.int32)
        arrays.update({name + "_toks": toks, name + "_labels": labels,
                       **{f"p_{name}:{k}": v
                          for k, v in np_params[name].items()}})
        inp[name + "_toks"] = torch.from_numpy(toks)
        inp[name + "_labels"] = torch.from_numpy(labels)
        inp["params"][name] = _nest(np_params[name])
    np.savez(work / "jax_in.npz", **arrays)
    torch.save(inp, work / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=str(SRC), WORLD_SIZE="4",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(work)],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_REF, str(work / "jax_in.npz"),
         str(work / "jax_out.npz")],
        env=dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for what, p in [(f"rank {i}", p) for i, p in enumerate(procs)] + [
            ("JAX's reference", jax_proc)]:
        log, _ = p.communicate(timeout=240)
        assert p.returncode == 0, f"{what} failed:\n{log}"
    with np.load(work / "jax_out.npz") as z:
        jx = {k: z[k] for k in z.files}
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    print(f"sp_axis fixture: {time.perf_counter() - t0:.1f} s")
    return dict(ranks=ranks, jax=jx, np_params=np_params)


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


def _rows(r, n_data):
    """The global batch rows a rank of (data=n_data, ...) holds."""
    i = r["coords"]["data"] if n_data > 1 else 0
    block = GB // n_data
    return slice(i * block, (i + 1) * block)


@pytest.mark.parametrize("m", list(MESHES))
def test_sp_step_is_default_bitwise_and_matches_jax(runs, m):
    """(i): logits and loss bitwise ``default``'s on the same mesh, every
    gradient leaf bitwise but the norm gains' (rtol 1e-5), and all of
    it against JAX's ``sp`` step (the logits the rank's rows)."""
    jx = runs["jax"]
    jg = _jax_tree(jx, f"sp_{m}_g")
    n_data = dict(MESHES[m])["data"]
    for r in runs["ranks"]:
        sp, dflt = r["sp_" + m], r["default_" + m]
        assert torch.equal(sp["logits"], dflt["logits"])
        assert torch.equal(sp["loss"], dflt["loss"])
        got, base = _flat(sp["grads"]), _flat(dflt["grads"])
        assert got.keys() == base.keys() == jg.keys()
        for p, g in got.items():
            if p in NORMS:
                _close(g, base[p], f"{m} sp grad {p} against default")
            else:
                assert np.array_equal(g, base[p]), (m, p)
            _close(g, jg[p], f"{m} sp grad {p} against JAX")
        _close(sp["logits"].numpy(), jx[f"sp_{m}:logits"][_rows(r, n_data)],
               f"{m} sp logits")
        np.testing.assert_allclose(float(sp["loss"]),
                                   float(jx[f"sp_{m}:loss"]), rtol=RTOL)
        np.testing.assert_allclose(sp["grad_norm"],
                                   float(jx[f"sp_{m}:gnorm"]), rtol=RTOL)


@pytest.mark.parametrize("m", list(MESHES))
def test_sp_keeps_the_rank_block_and_equal_norm_gains(runs, m):
    """(i): under ``sp`` each checkpointed layer input is the rank's
    ``[B, T / m, d]`` (``default``'s the whole ``[B, T, d]``); after an
    AdamW step every rank holds the same norm gains (their gradient
    summed over ``model``), and each rank's parameter bytes are
    ``shard_bytes``'s."""
    cfg = _cfgs()["dense"]
    axes = dict(MESHES[m])
    rows, n_model = GB // axes["data"], axes["model"]
    ranks = runs["ranks"]
    for r in ranks:
        sp, dflt = r["sp_" + m], r["default_" + m]
        assert sp["saved"] == [(rows, T // n_model, cfg.d_model)] * \
            cfg.n_layers, sp["saved"]
        assert dflt["saved"] == [(rows, T, cfg.d_model)] * cfg.n_layers
        got, want = sp["bytes"]
        assert got == want < sum(v.nbytes for v in
                                 runs["np_params"]["dense"].values())
    for p in NORMS + ("ln_f/g",):
        for r in ranks[1:]:
            assert np.array_equal(r["sp_" + m]["p1_blocks"][p],
                                  ranks[0]["sp_" + m]["p1_blocks"][p]), p


def test_sp_chunked_matches_jax(runs):
    """(ii): ``sp_chunked`` on (2, 2): logits, loss and gradients against
    JAX's."""
    jx = runs["jax"]
    jg = _jax_tree(jx, "sp_chunked_g")
    for r in runs["ranks"]:
        out = r["sp_chunked"]
        _close(out["logits"].numpy(), jx["sp_chunked:logits"][_rows(r, 2)],
               "sp_chunked logits")
        np.testing.assert_allclose(float(out["loss"]),
                                   float(jx["sp_chunked:loss"]), rtol=RTOL)
        for p, g in _flat(out["grads"]).items():
            _close(g, jg[p], f"sp_chunked grad {p}")
        assert out["saved"][0][1] == T // 2


def test_moe_local_sp_matches_jax(runs):
    """(iii): moonshot ``moe_local_sp`` on (2, 2): each rank's logits (its
    data block, whole over ``model``) and the aux loss against JAX's
    ``moe_apply_local`` under the same constraints."""
    jx = runs["jax"]
    for r in runs["ranks"]:
        out = r["moe_local_sp"]
        _close(out["logits"].numpy(),
               jx["moe_local_sp:logits"][_rows(r, 2)], "moe_local_sp logits")
        np.testing.assert_allclose(out["aux"], float(jx["moe_local_sp:aux"]),
                                   rtol=RTOL)


@pytest.mark.parametrize("prompt", PROMPTS)
def test_sp_prefill_and_decode_are_default_bitwise(runs, prompt):
    """(iv) on (2, 2): a prefill whose prompt splits over ``model`` (12)
    or stays whole (11), then DECODE steps (T = 1 stays whole): every
    step's logits and the gathered cache bitwise ``default``'s."""
    for r in runs["ranks"]:
        sp, dflt = r[f"serve_sp_{prompt}"], r[f"serve_dense_{prompt}"]
        for a, b in zip(sp["logits"], dflt["logits"]):
            assert torch.equal(a, b)
        for k in ("k", "v"):
            assert torch.equal(sp["cache"][k], dflt["cache"][k])


def test_sp_under_fsdp_is_fsdp_bitwise(runs):
    """(v): under ``fsdp`` the rows already split over ``model``: the
    constraint moves nothing, and the step is ``fsdp``'s bit for bit
    (each checkpointed input the rank's whole sequence)."""
    for r in runs["ranks"]:
        sp, base = r["sp_fsdp"], r["fsdp"]
        assert torch.equal(sp["logits"], base["logits"])
        assert torch.equal(sp["loss"], base["loss"])
        got, want = _flat(sp["grads"]), _flat(base["grads"])
        for p, g in got.items():
            assert np.array_equal(g, want[p]), p
        assert sp["saved"] == base["saved"] and sp["saved"][0][1] == T


def test_sp_on_an_abstract_mesh_raises_value_error():
    """(vi): a real tensor that an abstract ``model`` axis would split has
    no process to hold its block: ``ValueError``; one that does not
    divide (T = 7 over 2) stays whole, as JAX's constraint leaves it."""
    cfg = _cfgs()["sp"].replace(remat=False)
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    ids = torch.zeros(2, 8, dtype=torch.long)
    with use_mesh(mesh_lib.Mesh(("data", "model"), (1, 2))):
        with pytest.raises(ValueError, match="seq_parallel.*abstract mesh"):
            api.forward(params, ids)
        got, _ = api.forward(params, ids[:, :7])
    want, _ = get_model(_cfgs()["dense"]).forward(params, ids[:, :7])
    assert torch.equal(got, want)


if __name__ == "__main__":
    _rank_main(pathlib.Path(sys.argv[1]))
