"""Serving the decoders over a ``model`` axis of processes, against ``repro``.

The profiles whose serve steps move values differently from
``default``'s: ``cache_seq`` (the KV cache's positions split over
``model``: new tokens' k/v carried to their blocks by an all-to-all, the
read a distributed softmax), ``infer2d`` and ``fsdp`` (the layers
gathered where they are used, a prefill's rows split over every axis,
the cache's rows over ``(pod, data)`` and its kv heads over ``model``),
their W8 forms, the ``moe_local`` dispatch under a batch split over
``model``, and training under ``infer2d`` and ``cache_seq``.

Ranks: gloo processes on the CPU, this file run as a script (no JAX
import), meeting through a ``FileStore``: four as ``(data=2, model=2)``
and ``(data=1, model=4)``, two as ``(data=1, model=2)``.  JAX runs once,
in one subprocess with ``--xla_force_host_platform_device_count=4``, on
``jax.sharding.Mesh`` (``jax.make_mesh`` makes Explicit axes in jax
0.9.0, where the embedding gather raises): its ``prefill`` and
``decode_step`` jitted with ``params_shardings``, ``batch_shardings`` and
``cache_shardings`` of the profile as in-shardings (JAX's own
``constrain_batch`` fails under 0.9.0).  Weights and tokens come from
``np.random.default_rng``; the W8 trees are the port's
``quantize_tree`` export, fed to both packages.

Smoke configs in f32; tolerances rtol 1e-5 and atol 1e-5 of max|x| for
the logits at every step and for the gathered cache (float32 sums in
another order: the partial softmaxes, the row blocks' partial products).

* (i) tinyllama ``cache_seq`` on (1, 2): ``MAX_LEN`` 32, prompt 12 and 8
  decodes, so the writes cross the block boundary at 16; (ii) the same
  on (2, 2); (iii) (1, 4) with prompt 4 (three ranks' blocks start
  empty), and ``MAX_LEN`` 30 on (1, 4), which does not divide, so the
  cache stays whole; moonshot (the global route, expert parallel) under
  ``cache_seq`` on (1, 2).
* (iv) ``infer2d`` on (2, 2), batch 4; internvl2's stub embeddings too.
* (v) ``fsdp`` serving bitwise ``infer2d``'s.
* (vi) ``w8_cache_seq`` and ``w8_2d`` on (2, 2).
* (vii) moonshot ``moe_local`` under a step profile of ``fsdp`` on (2,
  2): logits, aux, loss and gathered gradients against JAX's
  ``moe_apply_local`` under ``fsdp``'s shardings.
* (viii) the ``infer2d`` training step bitwise ``fsdp``'s, and
  ``cache_seq``'s bitwise ``default``'s.

Each rank's cache block has the shape ``cache_pspec`` gives (never the
whole cache, except where ``MAX_LEN`` 30 does not divide), and its
parameter bytes are ``rules.shard_bytes``'s.
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
from repro_torch.core.quant import quantize_tree
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as tsteps
from repro_torch.launch.dryrun import apply_variant
from repro_torch.models.api import get_model
from repro_torch.sharding import rules
from repro_torch.sharding.context import use_mesh, use_placement
from repro_torch.train import train_loop as tloop
from repro_torch.tree import leaves_with_paths

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
DENSE, MOE, VLM = "tinyllama-1.1b", "moonshot-v1-16b-a3b", "internvl2-26b"
B, PROMPT, DECODE, MAX_LEN = 4, 12, 8, 32
GB, T = 8, 16                   # (vii) and (viii): global batch, sequence
CF = 0.5                        # moonshot's capacity factor in (vii)
LR = 3e-4
RTOL = 1e-5
MESHES = {"m12": (("data", 1), ("model", 2)),
          "m22": (("data", 2), ("model", 2)),
          "m14": (("data", 1), ("model", 4))}
# name: (arch key, profile, mesh, prompt, max_len)
SERVE = {"cs12": ("dense", "cache_seq", "m12", PROMPT, MAX_LEN),
         "cs22": ("dense", "cache_seq", "m22", PROMPT, MAX_LEN),
         "cs14": ("dense", "cache_seq", "m14", 4, MAX_LEN),
         "cs14_whole": ("dense", "cache_seq", "m14", PROMPT, 30),
         "moe_cs12": ("moe", "cache_seq", "m12", PROMPT, MAX_LEN),
         "infer2d22": ("dense", "infer2d", "m22", PROMPT, MAX_LEN),
         "vlm_infer2d22": ("vlm", "infer2d", "m22", PROMPT, MAX_LEN),
         "w8_cache_seq22": ("w8", "cache_seq", "m22", PROMPT, MAX_LEN),
         "w8_2d22": ("w8", "infer2d", "m22", PROMPT, MAX_LEN)}
# the port's alone: compared bitwise with the case it names
BITWISE = {"fsdp22": ("dense", "fsdp", "m22", PROMPT, MAX_LEN,
                      "infer2d22")}
TRAIN_PAIRS = (("infer2d", "fsdp"), ("cache_seq", "default"))


def _cfg(arch, profile="default"):
    if arch == "w8":
        return apply_variant(_cfg("dense"), "w8_" + (
            "2d" if profile == "infer2d" else profile))
    cfg = get_smoke_config({"dense": DENSE, "moe": MOE, "vlm": VLM}[arch])
    cfg = cfg.replace(dtype="float32", sharding_profile=profile)
    return cfg


def _moe_local_cfg():
    return _cfg("moe", "moe_local").replace(capacity_factor=CF)


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


# --------------------------------------------------------- the ranks --

def _serve_case(inp, mesh, arch, profile, prompt, max_len):
    """A prefill and DECODE steps through the step builders on this rank's
    blocks: the logits of each step (the rank's ``(pod, data)`` rows),
    the gathered cache, the cache block and what the rules say it is,
    and the parameter bytes against ``shard_bytes``."""
    api = get_model(_cfg(arch, profile))
    params = from_numpy_tree(inp["params"][arch])
    pl = tloop.placement(api, mesh, profile,
                         quantized=tsteps._quantized(params))
    local = rules.place(params, pl.params)
    seq = inp["toks"][arch]
    cache = api.init_cache(B, max_len, device="cpu")
    whole = tuple(cache["k"].shape)
    csh = rules.cache_shardings(cache, mesh, profile)
    cache = rules.place(cache, csh)
    block = tuple(cache["k"].shape)
    logits = []
    with use_mesh(mesh):
        lg, cache = tsteps.build_prefill_step(api, profile)(
            local, {"tokens": seq[:, :prompt]}, cache)
        logits.append(lg)
        decode = tsteps.build_decode_step(api)
        for i in range(DECODE):
            lg, cache = decode(local, {"token": seq[:, prompt + i],
                                       "pos": prompt + i}, cache)
            logits.append(lg)
    return {"logits": logits, "cache": rules.gather(cache, csh),
            "block": block, "whole": whole,
            "block_rule": csh["k"].shard_shape(whole),
            "bytes": (_nbytes(local), rules.shard_bytes(params, pl.params),
                      _nbytes(params))}


def _moe_fsdp_case(inp, mesh):
    """(vii): moonshot ``moe_local`` under the ``fsdp`` placement: the
    forward (this rank's rows), aux, loss and gathered gradients."""
    api = get_model(_moe_local_cfg())
    params = from_numpy_tree(inp["params"]["moe"])
    step, _ = tloop.build_accumulating_step(api, _tc(), mesh, "fsdp")
    pl = step.placement(mesh)
    local = rules.place(params, pl.params)
    batch = {k: rules.constrain_batch(torch.from_numpy(inp[k]).long(), mesh,
                                      "fsdp")
             for k in ("moe_tokens", "moe_labels")}
    with use_placement(pl):
        logits, aux = api.forward(local, batch["moe_tokens"])
        (loss, _), g = tloop.value_and_grad(api.loss_fn, local, {
            "tokens": batch["moe_tokens"], "labels": batch["moe_labels"]})
    g = tloop.group_mean(g, mesh, pl)
    return {"logits": logits.detach(), "aux": float(aux),
            "loss": float(tloop._metrics_mean({"loss": loss}, mesh,
                                              pl)["loss"]),
            "grads": rules.gather(g, pl.params),
            "row_block": rules.block_index(mesh, ("data", "model"))}


def _train_case(inp, mesh, profile):
    """(viii): one AdamW step of tinyllama under ``profile``: the params
    gathered whole and the metrics."""
    api = get_model(_cfg("dense"))
    params = from_numpy_tree(inp["params"]["dense"])
    step, init_opt = tloop.build_accumulating_step(api, _tc(), mesh, profile)
    pl = step.placement(mesh)
    local = rules.place(params, pl.params)
    batch = {k: torch.from_numpy(inp[k]).long()
             for k in ("train_tokens", "train_labels")}
    p1, _, m1 = step(local, init_opt(local), {
        "tokens": batch["train_tokens"], "labels": batch["train_labels"]}, 3)
    return {"p1": rules.gather(p1, pl.params),
            "metrics": {k: float(v) for k, v in m1.items()}}


def _rank_main(work: pathlib.Path, world: str) -> None:
    torch.set_num_threads(1)
    dev = mesh_lib.init_distributed(
        "cpu", init_method=f"file://{work}/store_{world}")
    inp = torch.load(work / "inputs.pt", weights_only=False)
    inp["toks"] = {k: torch.from_numpy(v) if v.dtype == np.float32
                   else torch.from_numpy(v).long()
                   for k, v in inp["toks"].items()}
    names = ("m12",) if world == "two" else ("m22", "m14")
    meshes = {n: mesh_lib.make_group_mesh(MESHES[n], dev) for n in names}
    out = {"rank": torch.distributed.get_rank()}
    for key, (arch, profile, m, prompt, max_len, *_) in {**SERVE,
                                                         **BITWISE}.items():
        if m in meshes:
            out[key] = _serve_case(inp, meshes[m], arch, profile, prompt,
                                   max_len)
    if world == "two":
        # a cache block made by hand: its shape cannot say it is a block
        api = get_model(_cfg("dense", "cache_seq"))
        params = from_numpy_tree(inp["params"]["dense"])
        local = rules.place(params, rules.params_shardings(
            params, meshes["m12"], "cache_seq"))
        try:
            with use_mesh(meshes["m12"]):
                tsteps.build_prefill_step(api, "cache_seq")(
                    local, {"tokens": inp["toks"]["dense"][:, :PROMPT]},
                    api.init_cache(B, MAX_LEN // 2, device="cpu"))
            out["unplaced"] = None
        except ValueError as e:
            out["unplaced"] = str(e)
    if world == "four":
        out["moe_fsdp"] = _moe_fsdp_case(inp, meshes["m22"])
        for pair in TRAIN_PAIRS:
            for profile in pair:
                out["train_" + profile] = _train_case(inp, meshes["m22"],
                                                      profile)
    torch.save(out, work / f"{world}{out['rank']}.pt")
    torch.distributed.destroy_process_group()


# ------------------------------------------------------- JAX's side --

JAX_REF = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.core.quant import QuantConfig
from repro.models.api import get_model
from repro.sharding import rules
from repro.sharding.context import set_mesh

z = np.load(sys.argv[1], allow_pickle=True)
SERVE = z["serve"].item()
DECODE, CF = int(z["decode"]), float(z["cf"])
ARCH = {"dense": "tinyllama-1.1b", "moe": "moonshot-v1-16b-a3b",
        "vlm": "internvl2-26b", "w8": "tinyllama-1.1b"}
devs = np.array(jax.devices())
meshes = {"m12": Mesh(devs[:2].reshape(1, 2), ("data", "model")),
          "m22": Mesh(devs.reshape(2, 2), ("data", "model")),
          "m14": Mesh(devs.reshape(1, 4), ("data", "model"))}
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

def cfg_of(arch, profile):
    cfg = get_smoke_config(ARCH[arch]).replace(dtype="float32",
                                               sharding_profile=profile)
    if arch == "w8":
        cfg = cfg.replace(quant=QuantConfig(w_bits=8, a_bits=16,
                                            backend="int8_ref"))
    return cfg

def serve(key, arch, profile, mesh, prompt, max_len):
    api = get_model(cfg_of(arch, profile))
    params = tree("p_" + arch)
    seq = jnp.asarray(z["toks_" + arch])
    psh = rules.params_shardings(params, mesh, profile)
    cache = api.init_cache(seq.shape[0], max_len)
    csh = rules.cache_shardings(cache, mesh, profile)
    first = {"tokens": seq[:, :prompt]}
    nxt = {"token": seq[:, prompt], "pos": jnp.asarray(prompt, jnp.int32)}
    prefill = jax.jit(api.prefill, in_shardings=(
        psh, rules.batch_shardings(first, mesh, profile), csh))
    decode = jax.jit(api.decode_step, in_shardings=(
        psh, rules.batch_shardings(nxt, mesh, profile), csh))
    lg, cache = prefill(params, first, cache)
    out[key + ":logits0"] = np.asarray(lg)
    for i in range(DECODE):
        cache = jax.device_put(cache, csh)   # the step's out-sharding differs
        lg, cache = decode(params, {"token": seq[:, prompt + i],
                                    "pos": jnp.asarray(prompt + i,
                                                       jnp.int32)}, cache)
        out[f"{key}:logits{i + 1}"] = np.asarray(lg)
    put(key + "_cache", cache)

for key, (arch, profile, m, prompt, max_len) in SERVE.items():
    serve(key, arch, profile, meshes[m], prompt, max_len)

# (vii) moe_local under fsdp's shardings
mesh = meshes["m22"]
set_mesh(mesh)
api = get_model(cfg_of("moe", "moe_local").replace(capacity_factor=CF))
params = tree("p_moe")
b = {"tokens": jnp.asarray(z["moe_tokens"]),
     "labels": jnp.asarray(z["moe_labels"])}
psh = rules.params_shardings(params, mesh, "fsdp")
bsh = rules.batch_shardings(b, mesh, "fsdp")
logits, aux = jax.jit(api.forward, in_shardings=(psh, bsh["tokens"]))(
    params, b["tokens"])
(loss, _), g = jax.jit(jax.value_and_grad(api.loss_fn, has_aux=True),
                       in_shardings=(psh, bsh))(params, b)
set_mesh(None)
out["moe_fsdp:logits"] = np.asarray(logits)
out["moe_fsdp:aux"] = np.asarray(aux)
out["moe_fsdp:loss"] = np.asarray(loss)
put("moe_fsdp_g", g)
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
    """Inputs drawn; the six ranks and JAX's reference process run at
    once."""
    work = tmp_path_factory.mktemp("serve_axis")
    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    np_params = {a: _np_params(_cfg(a), rng) for a in ("dense", "moe", "vlm")}
    qcfg = _cfg("w8", "cache_seq").quant
    np_params["w8"] = _flat(quantize_tree(
        from_numpy_tree(_nest(np_params["dense"])), qcfg))
    vocab = _cfg("dense").vocab_size
    toks = {a: rng.integers(0, vocab, (B, PROMPT + DECODE)).astype(np.int32)
            for a in ("dense", "moe")}
    toks["w8"] = toks["dense"]
    toks["vlm"] = rng.standard_normal(
        (B, PROMPT + DECODE, _cfg("vlm").d_model)).astype(np.float32)
    inp = {"params": {a: _nest(v) for a, v in np_params.items()},
           "toks": toks}
    for name, shape in (("moe", (GB, T)), ("train", (GB, T))):
        for k in ("tokens", "labels"):
            inp[f"{name}_{k}"] = rng.integers(0, vocab, shape).astype(
                np.int32)
    arrays = {"serve": np.array(SERVE, dtype=object), "decode": DECODE,
              "cf": CF, "moe_tokens": inp["moe_tokens"],
              "moe_labels": inp["moe_labels"],
              **{f"toks_{a}": v for a, v in toks.items()},
              **{f"p_{a}:{k}": v for a, p in np_params.items()
                 for k, v in p.items()}}
    np.savez(work / "jax_in.npz", **arrays)
    torch.save(inp, work / "inputs.pt")
    procs = _spawn(work, "four", 4) + _spawn(work, "two", 2)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_REF, str(work / "jax_in.npz"),
         str(work / "jax_out.npz")],
        env=dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for i, p in enumerate(procs):
        _join(p, f"rank {i}")
    _join(jax_proc, "JAX's reference")
    with np.load(work / "jax_out.npz") as z:
        jx = {k: z[k] for k in z.files}
    ranks = {w: [torch.load(work / f"{w}{r}.pt") for r in range(n)]
             for w, n in (("four", 4), ("two", 2))}
    print(f"serve_axis fixture: {time.perf_counter() - t0:.1f} s")
    return dict(ranks=ranks, jax=jx)


# ------------------------------------------------------------ checks --

def _close(got, want, what, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=RTOL * scale,
                               err_msg=what)


def _outs(runs, key):
    m = (SERVE.get(key) or BITWISE[key])[2]
    return runs["ranks"]["two" if m == "m12" else "four"]


def _data_rows(out, key, n_rows):
    """The global rows a rank's serve logits cover: its ``(pod, data)``
    block."""
    m = dict(MESHES[(SERVE.get(key) or BITWISE[key])[2]])
    d = out["rank"] // m["model"]
    per = n_rows // m["data"]
    return slice(d * per, (d + 1) * per)


@pytest.mark.parametrize("key", list(SERVE))
def test_serving_matches_jax(runs, key):
    """(i)-(iv), (vi): every step's logits on every rank (its data
    block's rows) and the gathered cache against JAX's jitted prefill and
    decode under the profile's shardings."""
    jx = runs["jax"]
    for out in _outs(runs, key):
        r = out[key]
        assert len(r["logits"]) == DECODE + 1
        for i, lg in enumerate(r["logits"]):
            want = jx[f"{key}:logits{i}"]
            _close(lg.numpy(), want[_data_rows(out, key, want.shape[0])],
                   f"{key} logits {i} rank {out['rank']}")
        for k in ("k", "v"):
            _close(r["cache"][k].numpy(), jx[f"{key}_cache:{k}"],
                   f"{key} cache {k} rank {out['rank']}")


@pytest.mark.parametrize("key", list(SERVE) + list(BITWISE))
def test_each_rank_holds_its_blocks(runs, key):
    """Each rank's cache block has the shape ``cache_pspec`` gives it and
    is never the whole cache (but where ``MAX_LEN`` 30 does not divide
    over model=4 and data=1: the rules leave it whole); its parameter
    bytes are ``rules.shard_bytes``'s, below the whole tree's."""
    profile = (SERVE.get(key) or BITWISE[key])[1]
    for out in _outs(runs, key):
        r = out[key]
        assert r["block"] == r["block_rule"], (key, r["block"])
        if key == "cs14_whole":
            assert r["block"] == r["whole"]
        else:
            assert r["block"] != r["whole"]
            # cache_seq splits the positions, the others the kv heads
            dim = 2 if "cache_seq" in profile else 3
            assert r["block"][dim] < r["whole"][dim], (key, r["block"])
        got, shard, whole = r["bytes"]
        assert got == shard < whole, (key, r["bytes"])


def test_fsdp_serves_bitwise_infer2d(runs):
    """(v) ``fsdp``'s serve steps are ``infer2d``'s: the same placements
    and the same program, so every step's logits and the cache bit for
    bit."""
    for out in _outs(runs, "fsdp22"):
        a, b = out["fsdp22"], out[BITWISE["fsdp22"][-1]]
        for x, y in zip(a["logits"], b["logits"]):
            assert torch.equal(x, y)
        for k in ("k", "v"):
            assert torch.equal(a["cache"][k], b["cache"][k])


def test_moe_local_under_fsdp_matches_jax(runs):
    """(vii) moonshot ``moe_local`` at capacity factor 0.5 under the
    ``fsdp`` placement on (2, 2), the rows split over every axis: each
    rank gathers its data block's rows over ``model``, cuts its experts
    from the gathered layer and keeps its rows; its logits, the aux, the
    loss and every gathered gradient leaf against JAX's
    ``moe_apply_local`` jitted under ``fsdp``'s shardings."""
    jx = runs["jax"]
    want = jx["moe_fsdp:logits"]
    per = want.shape[0] // 4
    jg = {k[len("moe_fsdp_g:"):]: v for k, v in jx.items()
          if k.startswith("moe_fsdp_g:")}
    for out in runs["ranks"]["four"]:
        r = out["moe_fsdp"]
        i = r["row_block"]
        _close(r["logits"].numpy(), want[i * per:(i + 1) * per],
               f"moe_fsdp logits rank {out['rank']}")
        np.testing.assert_allclose(r["aux"], float(jx["moe_fsdp:aux"]),
                                   rtol=RTOL)
        np.testing.assert_allclose(r["loss"], float(jx["moe_fsdp:loss"]),
                                   rtol=RTOL)
        grads = _flat(r["grads"])
        assert grads.keys() == jg.keys()
        for p, w in jg.items():
            _close(grads[p], w, f"moe_fsdp grad {p}")


@pytest.mark.parametrize("pair", TRAIN_PAIRS, ids=lambda p: "_".join(p))
def test_training_step_bitwise(runs, pair):
    """(viii) ``infer2d``'s parameter and batch rules are ``fsdp``'s, and
    ``cache_seq`` places parameters and batch as ``default`` does: one
    AdamW step under each on (2, 2), params and metrics bit for bit."""
    a, b = pair
    for out in runs["ranks"]["four"]:
        assert out["train_" + a]["metrics"] == out["train_" + b]["metrics"]
        pa, pb = (_flat(out["train_" + p]["p1"]) for p in pair)
        assert pa.keys() == pb.keys()
        for k, v in pa.items():
            assert np.array_equal(v, pb[k]), (pair, k)


def test_an_unplaced_cache_block_raises(runs):
    """Under ``cache_seq`` a block of 16 slots made by hand (not by
    ``rules.place``, whose blocks remember their whole shape) could be a
    whole cache or half of one: 16 divides over model=2, so the rules
    would have split a whole one, and the step raises."""
    for out in runs["ranks"]["two"]:
        assert out["unplaced"] is not None and \
            "rules.place" in out["unplaced"], out["unplaced"]


def test_every_profile_moves_values():
    """Without a process group a serve step has no placement; the rules'
    profiles all move values now, and an unknown one raises."""
    for profile in ("default", "replicated", "fsdp", "infer2d", "cache_seq",
                    "w8_cache_seq", "moe_local"):
        assert rules.moves_values(profile)
    with pytest.raises(ValueError, match="unknown sharding profile"):
        rules.moves_values("zero3")
    api = get_model(_cfg("dense", "cache_seq"))
    assert tloop.placement(api, None, "cache_seq") is None
    assert tsteps.serve_placement(None, {}, {}, decode=True) is None
    x = torch.arange(12.0).reshape(4, 3)
    assert rules.whole_shape(x) == (4, 3)


if __name__ == "__main__":
    _rank_main(pathlib.Path(sys.argv[1]), sys.argv[2])
