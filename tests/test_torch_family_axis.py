"""xLSTM, Hymba and Whisper trained over a ``model`` axis of processes,
against ``repro`` on forced host devices.

Under ``default`` each rank holds the blocks ``rules.params_shardings``
gives it and computes JAX's function on them: the mLSTM and Hymba's SSM
split by heads (``layers.HeadSplit``; xLSTM's two heads over four ranks
take the branch where every rank runs every head), the sLSTM runs whole
on every rank and feeds ``wo``'s row block its columns, the attention
(Hymba's, Whisper's self- and cross-attention) splits as the decoder's,
Whisper's MLP by ``fc1`` columns and ``fc2`` rows, and the embeddings by
vocab.  Under ``fsdp`` each layer's leaves are gathered where it runs
and the batch splits over every axis.

* A training step of each smoke config (f32, remat on) under
  ``default`` and ``fsdp`` on (data=2, model=2), and xLSTM's under
  ``default`` on (data=1, model=4): the loss, the step's grad norm and
  every gathered gradient leaf against JAX's ``value_and_grad`` jitted
  with the profile's ``params_shardings`` and ``batch_shardings`` as
  in-shardings, at rtol 1e-5 and atol 1e-5 of each leaf's max|g|.
  xLSTM's float32 gradients sit near that tolerance between any two
  programs (its recurrences), and JAX's own (1, 4) program lands about
  1.04 times the tolerance from a float64 evaluation of the port, so
  the (1, 4) case is held against JAX's program on one device.
* Each rank's leaves have the rules' block shapes, its parameter bytes
  are ``rules.shard_bytes``'s, and the leaves every rank holds whole are
  the same bits on every rank after an AdamW step.
* A prefill step of each over ``model`` on (2, 2), from the placed
  weights and cache, returns each rank's rows of one process's logits
  (their parity with JAX's sharded serve steps is
  ``tests/test_torch_family_serve_axis.py``'s).

Ranks: four gloo processes on the CPU, spawned once, this file run as a
script (no JAX import), meeting through a ``FileStore``.  JAX runs once,
in one subprocess with ``--xla_force_host_platform_device_count=4``, on
``jax.sharding.Mesh(devices.reshape(2, 2), ("data", "model"))`` (never
``jax.make_mesh``).  Weights, tokens and Whisper's stub frames come from
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
from repro_torch.models.api import get_model
from repro_torch.sharding import rules
from repro_torch.sharding.context import use_mesh, use_placement
from repro_torch.train import train_loop as tloop
from repro_torch.tree import leaves_with_paths

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
ARCHS = ("xlstm-1.3b", "hymba-1.5b", "whisper-tiny")
GB, T = 8, 16                           # global batch, sequence
LR = 3e-4
RTOL = 1e-5
MESHES = {"m22": (("data", 2), ("model", 2)),
          "m14": (("data", 1), ("model", 4))}
# key: (arch, profile, mesh, JAX's mesh: "one" for one device)
CASES = {f"{a}:{p}": (a, p, "m22", "m22") for a in ARCHS
         for p in ("default", "fsdp")}
CASES["xlstm-1.3b:default14"] = ("xlstm-1.3b", "default", "m14", "one")


def _cfg(arch):
    return get_smoke_config(arch).replace(dtype="float32", remat=True)


def _tc():
    return TrainConfig(optimizer="adamw", lr=LR, lr_min=LR / 10, steps=10,
                       batch_size=GB)


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


def _batch(inp, arch):
    return {k: v if v.is_floating_point() else v.long()
            for k, v in inp["batch"][arch].items()}


# --------------------------------------------------------- the ranks --

def _train_case(inp, mesh, arch, profile):
    """The loss, the gathered gradients and one AdamW step of ``arch``
    under ``profile`` on this rank's blocks."""
    api = get_model(_cfg(arch))
    params = from_numpy_tree(inp["params"][arch])
    step, init_opt = tloop.build_accumulating_step(api, _tc(), mesh, profile)
    pl = step.placement(mesh)
    local = rules.place(params, pl.params)
    whole = _batch(inp, arch)
    with use_placement(pl):
        (loss, _), g = tloop.value_and_grad(api.loss_fn, local, {
            k: rules.constrain_batch(v, mesh, profile)
            for k, v in whole.items()})
    p1, _, m1 = step(local, init_opt(local), whole, 3)
    sh = dict(leaves_with_paths(pl.params))
    return {"loss": float(tloop._metrics_mean({"loss": loss}, mesh,
                                              pl)["loss"]),
            "grads": _flat(rules.gather(tloop.group_mean(g, mesh, pl),
                                        pl.params)),
            "metrics": {k: float(v) for k, v in m1.items()},
            "shapes": {"/".join(map(str, p)): (
                tuple(x.shape), sh[p].shard_shape(tuple(w.shape)))
                for (p, x), (_, w) in zip(leaves_with_paths(local),
                                          leaves_with_paths(params))},
            "whole_after": {"/".join(map(str, p)): x.detach().numpy()
                            for p, x in leaves_with_paths(p1)
                            if all(a is None for a in sh[p].spec)},
            "bytes": (_nbytes(local), rules.shard_bytes(params, pl.params),
                      _nbytes(params))}


def _serve_run(inp, mesh, arch):
    """A prefill of the first 4 tokens on this rank's blocks of the
    weights and the cache (its data block's rows), and the same prefill
    on one process."""
    api = get_model(_cfg(arch))
    params = from_numpy_tree(inp["params"][arch])
    local = rules.place(params, rules.params_shardings(params, mesh))
    batch = {k: v[:, :4] if k == "tokens" else v
             for k, v in _batch(inp, arch).items() if k != "labels"}
    whole = api.init_cache(GB, T, device="cpu")
    want, _ = api.prefill(params, batch, api.init_cache(GB, T, device="cpu"))
    cache = rules.place(whole, rules.cache_shardings(whole, mesh))
    with use_mesh(mesh):
        got, _ = tsteps.build_prefill_step(api)(local, batch, cache)
    rows = got.shape[0]
    d = rules.block_index(mesh, "data")
    return got, want[d * rows:(d + 1) * rows]


def _rank_main(work: pathlib.Path) -> None:
    torch.set_num_threads(1)
    dev = mesh_lib.init_distributed("cpu",
                                    init_method=f"file://{work}/store")
    inp = torch.load(work / "inputs.pt", weights_only=False)
    meshes = {k: mesh_lib.make_group_mesh(v, dev) for k, v in MESHES.items()}
    out = {"rank": torch.distributed.get_rank()}
    for key, (arch, profile, m, _) in CASES.items():
        out[key] = _train_case(inp, meshes[m], arch, profile)
    out["serve"] = {a: _serve_run(inp, meshes["m22"], a) for a in ARCHS}
    torch.save(out, work / f"rank{out['rank']}.pt")
    torch.distributed.destroy_process_group()


# ------------------------------------------------------- JAX's side --

JAX_REF = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.models.api import get_model
from repro.sharding import rules
from repro.train import optimizer as jopt

z = np.load(sys.argv[1])
devs = np.array(jax.devices())
meshes = {"m22": Mesh(devs.reshape(2, 2), ("data", "model"))}
CASES = [c.split("|") for c in sys.argv[3].split(",")]
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

for key, arch, profile, _, m in CASES:
    api = get_model(get_smoke_config(arch).replace(dtype="float32",
                                                   remat=True))
    params = tree("p_" + arch)
    b = tree("b_" + arch)

    def grads(params, b):
        (loss, _), g = jax.value_and_grad(api.loss_fn, has_aux=True)(
            params, b)
        return loss, g, jopt.clip_by_global_norm(g, 1.0)[1]
    if m == "one":
        loss, g, gnorm = jax.jit(grads)(params, b)
    else:
        mesh = meshes[m]
        with mesh:
            loss, g, gnorm = jax.jit(grads, in_shardings=(
                rules.params_shardings(params, mesh, profile),
                rules.batch_shardings(b, mesh, profile)))(params, b)
    out[key + ":loss"] = np.asarray(loss)
    out[key + ":gnorm"] = np.asarray(gnorm)
    for p, v in jax.tree_util.tree_flatten_with_path(g)[0]:
        out[key + "_g:" + "/".join(k.key for k in p)] = np.asarray(v)
np.savez(sys.argv[2], **out)
"""


def _np_params(cfg, rng):
    """Weights from ``rng`` with the init's tree, shapes and dtypes: N(0,
    1/fan_in) matrices and convs (the embeddings 0.02), norm gains near
    1, biases and skips N(0, 0.1)."""
    shapes = get_model(cfg).init(torch.Generator(), device="cpu")
    out = {}
    for path, t in leaves_with_paths(shapes):
        shape = tuple(t.shape)
        if path[-1] == "g":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif path[-1] == "table":
            v = 0.02 * rng.standard_normal(shape)
        elif len(shape) < 2 or path[-1] in ("b", "dskip"):
            v = 0.1 * rng.standard_normal(shape)
        else:
            v = shape[-2] ** -0.5 * rng.standard_normal(shape)
        out["/".join(map(str, path))] = v.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Inputs drawn; the four ranks and JAX's reference run at once."""
    work = tmp_path_factory.mktemp("family_axis")
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    arrays, inp = {}, {"params": {}, "batch": {}}
    np_params = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        np_params[arch] = _np_params(cfg, rng)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (GB, T)),
                 "labels": rng.integers(0, cfg.vocab_size, (GB, T))}
        batch = {k: v.astype(np.int32) for k, v in batch.items()}
        if cfg.family == "audio":
            batch["frames"] = rng.standard_normal(
                (GB, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        arrays.update({f"p_{arch}:{k}": v
                       for k, v in np_params[arch].items()})
        arrays.update({f"b_{arch}:{k}": v for k, v in batch.items()})
        inp["params"][arch] = _nest(np_params[arch])
        inp["batch"][arch] = {k: torch.from_numpy(v)
                              for k, v in batch.items()}
    np.savez(work / "jax_in.npz", **arrays)
    torch.save(inp, work / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=str(SRC), WORLD_SIZE="4",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(work)],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    cases = ",".join("|".join((k,) + v) for k, v in CASES.items())
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_REF, str(work / "jax_in.npz"),
         str(work / "jax_out.npz"), cases],
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
    print(f"family_axis fixture: {time.perf_counter() - t0:.1f} s")
    return dict(ranks=ranks, jax=jx, np_params=np_params)


# ------------------------------------------------------------ checks --

def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("key", list(CASES))
def test_training_step_matches_jax(runs, key):
    """The loss, the step's loss and grad norm, and every gathered
    gradient leaf, on every rank, against JAX's under the same
    placement."""
    jx = runs["jax"]
    jg = {k[len(key) + 3:]: v for k, v in jx.items()
          if k.startswith(key + "_g:")}
    for r in runs["ranks"]:
        out = r[key]
        np.testing.assert_allclose(out["loss"], float(jx[key + ":loss"]),
                                   rtol=RTOL, err_msg=key)
        np.testing.assert_allclose(out["metrics"]["loss"],
                                   float(jx[key + ":loss"]), rtol=RTOL)
        np.testing.assert_allclose(out["metrics"]["grad_norm"],
                                   float(jx[key + ":gnorm"]), rtol=RTOL)
        assert out["grads"].keys() == jg.keys()
        for p, w in jg.items():
            _close(out["grads"][p], w, f"{key} grad {p}")


@pytest.mark.parametrize("key", list(CASES))
def test_each_rank_holds_the_rules_blocks(runs, key):
    """Every leaf a rank holds has the block shape the rules give it
    (some split: the rank holds less than the whole tree), its bytes are
    ``shard_bytes``'s, and the whole leaves are the same bits on every
    rank after an AdamW step."""
    ranks = [r[key] for r in runs["ranks"]]
    for out in ranks:
        split = 0
        for p, (got, rule) in out["shapes"].items():
            assert got == rule, (key, p, got, rule)
        split = sum(got != tuple(runs["np_params"][key.split(":")[0]][p]
                                 .shape) for p, (got, _) in
                    out["shapes"].items())
        assert split > 0, key
        held, want, whole = out["bytes"]
        assert held == want < whole, out["bytes"]
    for out in ranks[1:]:
        assert out["whole_after"].keys() == ranks[0]["whole_after"].keys()
        for p, v in out["whole_after"].items():
            assert np.array_equal(v, ranks[0]["whole_after"][p]), (key, p)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_over_model_runs(runs, arch):
    """A prefill step of each family over (2, 2) from the placed weights
    and cache: each rank's logits, its data block's rows, within rtol
    1e-5 and atol 1e-5 of max|logit| of one process's prefill."""
    for r in runs["ranks"]:
        got, want = r["serve"][arch]
        _close(got.numpy(), want.numpy(), f"{arch} prefill rank {r['rank']}")


if __name__ == "__main__":
    _rank_main(pathlib.Path(sys.argv[1]))
