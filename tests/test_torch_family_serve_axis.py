"""xLSTM, Hymba and Whisper served over a ``model`` axis of processes,
against ``repro`` on forced host devices.

Each rank holds its ``rules.params_shardings`` block of the weights and
its ``rules.cache_pspec`` block of every cache leaf between steps, and
runs ``launch.steps.build_prefill_step``/``build_decode_step`` on them:

* the recurrent states ``S`` are read in place where they split
  (``linear_scan.recurrent_step``): xLSTM's ``m.S`` ``[G,M,B,h,dk,dv]``
  over ``dk`` (``default``, ``fsdp``, ``infer2d``) or its heads
  (``cache_seq``), Hymba's ``ssm.S`` ``[L,B,h,s,dv]`` over ``s`` or its
  heads; a key-dim block's partial reads are summed over ``model``;
* the leaves the rules place oddly (``n``, the conv states, the
  sLSTM's) are gathered to the layout the layers compute on and their
  block written back (``rules.cache_views``);
* Hymba's rolling window cache under ``cache_seq``: slot ``pos %
  window`` on the rank holding it, each slot masked by the position it
  holds; Whisper's cross cache by kv heads, or under ``cache_seq`` by
  encoder position (a distributed softmax with no causal mask).

Cases (smoke configs in f32, batch 4, prompt 12 and 8 decodes):

* each family under ``default`` on (data=1, model=4): xLSTM's two heads
  over four take the uneven route, every rank running every head on
  its key-dim block of the state;
* ``infer2d`` and ``fsdp`` on (2, 2): a prefill's rows split over every
  axis (one a rank), the layers gathered where they run;
* ``cache_seq`` on (1, 2) and (1, 4): Hymba's 16-slot window takes the
  12-token prompt and 8 decodes, so its writes wrap from the last slot
  to the first and cross a block boundary; Whisper's 16 encoder
  positions split;
* ``w8_cache_seq`` on (2, 2) for Hymba and Whisper (JAX's xLSTM has no
  quantized serve path).  The W8 trees are the port's ``quantize_tree``
  export, fed to both packages; Hymba's depthwise conv weight stays
  float in it, since both packages' ``_causal_conv`` multiply by it as
  an array.

Every step's logits (each rank's ``(pod, data)`` rows) and the gathered
cache are held to rtol 1e-5 and atol 1e-5 of max|x| against JAX's
``prefill``/``decode_step`` jitted with the profile's
``params_shardings``, ``batch_shardings`` and ``cache_shardings`` as
in-shardings on ``jax.sharding.Mesh`` (``jax.make_mesh`` makes Explicit
axes in jax 0.9.0), the cache put back to its sharding before each
decode.  Each rank's cache blocks have ``cache_pspec``'s shapes and
their bytes are ``rules.shard_bytes``'s, as are its parameter bytes.

Ranks: gloo processes on the CPU, this file run as a script (no JAX
import), spawned once as four ((2, 2) and (1, 4)) and two ((1, 2)),
meeting through a ``FileStore``.  JAX runs once, in one subprocess with
``--xla_force_host_platform_device_count=4``.
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
from repro_torch.convert import from_numpy_tree
from repro_torch.core.quant import is_quantizable_leaf_path, quantize_tree
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as tsteps
from repro_torch.launch.dryrun import apply_variant
from repro_torch.models.api import get_model
from repro_torch.sharding import rules
from repro_torch.sharding.context import use_mesh
from repro_torch.train import train_loop as tloop
from repro_torch.tree import leaves_with_paths

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
ARCHS = {"xlstm": "xlstm-1.3b", "hymba": "hymba-1.5b",
         "whisper": "whisper-tiny"}
B, PROMPT, DECODE, MAX_LEN = 4, 12, 8, 32
RTOL = 1e-5
MESHES = {"m12": (("data", 1), ("model", 2)),
          "m22": (("data", 2), ("model", 2)),
          "m14": (("data", 1), ("model", 4))}
# key: (arch, profile, mesh)
CASES = {}
for _a in ARCHS:
    CASES[f"{_a}:default14"] = (_a, "default", "m14")
    CASES[f"{_a}:infer2d22"] = (_a, "infer2d", "m22")
    CASES[f"{_a}:fsdp22"] = (_a, "fsdp", "m22")
    CASES[f"{_a}:cache_seq12"] = (_a, "cache_seq", "m12")
    CASES[f"{_a}:cache_seq14"] = (_a, "cache_seq", "m14")
for _a in ("hymba", "whisper"):
    CASES[f"{_a}:w8_cache_seq22"] = (_a, "w8_cache_seq", "m22")


def _cfg(arch, profile="default"):
    cfg = get_smoke_config(ARCHS[arch]).replace(dtype="float32")
    if profile.startswith("w8_"):
        return apply_variant(cfg, profile)
    return cfg.replace(sharding_profile=profile)


def _w8_paths(path, leaf):
    """The W8 export's weights: the matmul weights but a depthwise conv."""
    return is_quantizable_leaf_path(path) and leaf.ndim >= 2 and \
        "conv" not in map(str, path)


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

def _serve_case(inp, mesh, arch, profile):
    """A prefill and DECODE steps through the step builders on this rank's
    blocks: each step's logits (the rank's ``(pod, data)`` rows), the
    gathered cache, each cache block's shape beside the rules', and the
    cache's and parameters' bytes beside ``shard_bytes``."""
    api = get_model(_cfg(arch, profile))
    params = from_numpy_tree(inp["params"][
        arch + ("_w8" if profile.startswith("w8_") else "")])
    pl = tloop.placement(api, mesh, api.cfg.sharding_profile,
                         quantized=tsteps._quantized(params))
    local = rules.place(params, pl.params)
    seq = inp["toks"][arch]
    first = {"tokens": seq[:, :PROMPT]}
    if arch == "whisper":
        first["frames"] = inp["frames"]
    whole = api.init_cache(B, MAX_LEN, device="cpu")
    csh = rules.cache_shardings(whole, mesh, api.cfg.sharding_profile)
    cache = rules.place(whole, csh)
    sh = dict(leaves_with_paths(csh))
    blocks = {"/".join(map(str, p)): (tuple(x.shape),
                                      sh[p].shard_shape(tuple(w.shape)))
              for (p, x), (_, w) in zip(leaves_with_paths(cache),
                                        leaves_with_paths(whole))}
    cache_bytes = (_nbytes(cache), rules.shard_bytes(whole, csh),
                   _nbytes(whole))
    logits = []
    with use_mesh(mesh):
        lg, cache = tsteps.build_prefill_step(
            api, api.cfg.sharding_profile)(local, first, cache)
        logits.append(lg)
        decode = tsteps.build_decode_step(api)
        for i in range(DECODE):
            lg, cache = decode(local, {"token": seq[:, PROMPT + i],
                                       "pos": PROMPT + i}, cache)
            logits.append(lg)
    return {"logits": logits, "cache": _flat(rules.gather(cache, csh)),
            "blocks": blocks, "cache_bytes": cache_bytes,
            "after": {"/".join(map(str, p)): tuple(x.shape)
                      for p, x in leaves_with_paths(cache)},
            "bytes": (_nbytes(local), rules.shard_bytes(params, pl.params),
                      _nbytes(params))}


def _rank_main(work: pathlib.Path, world: str) -> None:
    torch.set_num_threads(1)
    dev = mesh_lib.init_distributed(
        "cpu", init_method=f"file://{work}/store_{world}")
    inp = torch.load(work / "inputs.pt", weights_only=False)
    names = ("m12",) if world == "two" else ("m22", "m14")
    meshes = {n: mesh_lib.make_group_mesh(MESHES[n], dev) for n in names}
    out = {"rank": torch.distributed.get_rank()}
    for key, (arch, profile, m) in CASES.items():
        if m in meshes:
            out[key] = _serve_case(inp, meshes[m], arch, profile)
    torch.save(out, work / f"{world}{out['rank']}.pt")
    torch.distributed.destroy_process_group()


# ------------------------------------------------------- JAX's side --

JAX_REF = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
from concurrent.futures import ThreadPoolExecutor
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.core.quant import QuantConfig
from repro.models.api import get_model
from repro.sharding import rules

z = np.load(sys.argv[1], allow_pickle=True)
CASES = z["cases"].item()
ARCHS = z["archs"].item()
PROMPT, DECODE, MAX_LEN = (int(z[k]) for k in ("prompt", "decode", "max_len"))
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

def lowered(key, arch, profile, m):
    # the case's prefill and decode programs lowered, and their inputs
    # put to their shardings
    # one model a family and quant: its programs trace once (JAX's xLSTM,
    # Hymba and Whisper read no sharding_profile; the shardings differ)
    w8 = profile.startswith("w8_")
    profile = profile.replace("w8_", "")
    if (arch, w8) not in apis:
        cfg = get_smoke_config(ARCHS[arch]).replace(dtype="float32")
        if w8:
            cfg = cfg.replace(quant=QuantConfig(w_bits=8, a_bits=16,
                                                backend="int8_ref"))
        apis[arch, w8] = get_model(cfg)
    api = apis[arch, w8]
    mesh = meshes[m]
    seq = jnp.asarray(z["toks_" + arch])
    params = tree("p_" + arch + ("_w8" if w8 else ""))
    psh = rules.params_shardings(params, mesh, profile)
    cache = api.init_cache(seq.shape[0], MAX_LEN)
    csh = rules.cache_shardings(cache, mesh, profile)
    first = {"tokens": seq[:, :PROMPT]}
    if arch == "whisper":
        first["frames"] = jnp.asarray(z["frames"])
    nxt = {"token": seq[:, PROMPT], "pos": jnp.asarray(PROMPT, jnp.int32)}
    fsh = rules.batch_shardings(first, mesh, profile)
    nsh = rules.batch_shardings(nxt, mesh, profile)
    return dict(
        prefill=jax.jit(api.prefill, in_shardings=(psh, fsh, csh)).lower(
            params, first, cache),
        decode=jax.jit(api.decode_step, in_shardings=(psh, nsh, csh)).lower(
            params, nxt, cache),
        params=jax.device_put(params, psh),
        first=jax.device_put(first, fsh), cache=jax.device_put(cache, csh),
        seq=seq, nsh=nsh, csh=csh)

# every program lowered, then compiled on four threads (XLA compiles
# without the GIL), then run
apis = {}
runs = {key: lowered(key, *case) for key, case in CASES.items()}
with ThreadPoolExecutor(4) as pool:
    done = dict(zip(
        [(k, f) for k in runs for f in ("prefill", "decode")],
        pool.map(lambda kf: runs[kf[0]][kf[1]].compile(),
                 [(k, f) for k in runs for f in ("prefill", "decode")])))
for key, r in runs.items():
    prefill, decode = done[key, "prefill"], done[key, "decode"]
    lg, cache = prefill(r["params"], r["first"], r["cache"])
    out[key + ":logits0"] = np.asarray(lg)
    for i in range(DECODE):
        cache = jax.device_put(cache, r["csh"])  # the step's out-sharding differs
        nxt = jax.device_put({"token": r["seq"][:, PROMPT + i],
                              "pos": jnp.asarray(PROMPT + i, jnp.int32)},
                             r["nsh"])
        lg, cache = decode(r["params"], nxt, cache)
        out[f"{key}:logits{i + 1}"] = np.asarray(lg)
    put(key + "_cache", cache)
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
    work = tmp_path_factory.mktemp("family_serve_axis")
    t0 = time.perf_counter()
    rng = np.random.default_rng(11)
    np_params = {a: _np_params(_cfg(a), rng) for a in ARCHS}
    for a in ("hymba", "whisper"):
        np_params[a + "_w8"] = _flat(quantize_tree(
            from_numpy_tree(_nest(np_params[a])),
            _cfg(a, "w8_cache_seq").quant, _w8_paths))
    toks = {a: rng.integers(0, _cfg(a).vocab_size,
                            (B, PROMPT + DECODE)).astype(np.int32)
            for a in ARCHS}
    frames = rng.standard_normal(
        (B, _cfg("whisper").enc_seq, _cfg("whisper").d_model)
    ).astype(np.float32)
    inp = {"params": {a: _nest(v) for a, v in np_params.items()},
           "toks": {a: torch.from_numpy(v).long() for a, v in toks.items()},
           "frames": torch.from_numpy(frames)}
    arrays = {"cases": np.array(CASES, dtype=object),
              "archs": np.array(ARCHS, dtype=object), "prompt": PROMPT,
              "decode": DECODE, "max_len": MAX_LEN, "frames": frames,
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
    ranks = {w: [torch.load(work / f"{w}{r}.pt", weights_only=False)
                 for r in range(n)] for w, n in (("four", 4), ("two", 2))}
    print(f"family_serve_axis fixture: {time.perf_counter() - t0:.1f} s")
    return dict(ranks=ranks, jax=jx)


# ------------------------------------------------------------ checks --

def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


def _outs(runs, key):
    return runs["ranks"]["two" if CASES[key][2] == "m12" else "four"]


def _data_rows(out, key, n_rows):
    """The global rows a rank's logits cover: its ``(pod, data)`` block."""
    m = dict(MESHES[CASES[key][2]])
    d = out["rank"] // m["model"]
    per = n_rows // m["data"]
    return slice(d * per, (d + 1) * per)


@pytest.mark.parametrize("key", list(CASES))
def test_serving_matches_jax(runs, key):
    """Every step's logits on every rank (its data block's rows) and every
    leaf of the gathered cache against JAX's jitted prefill and decode
    under the profile's shardings."""
    jx = runs["jax"]
    want_cache = {k[len(key) + 7:]: v for k, v in jx.items()
                  if k.startswith(key + "_cache:")}
    for out in _outs(runs, key):
        r = out[key]
        assert len(r["logits"]) == DECODE + 1
        for i, lg in enumerate(r["logits"]):
            want = jx[f"{key}:logits{i}"]
            _close(lg.numpy(), want[_data_rows(out, key, want.shape[0])],
                   f"{key} logits {i} rank {out['rank']}")
        assert r["cache"].keys() == want_cache.keys()
        for k, w in want_cache.items():
            _close(r["cache"][k], w, f"{key} cache {k} rank {out['rank']}")


@pytest.mark.parametrize("key", list(CASES))
def test_each_rank_holds_its_blocks(runs, key):
    """Each cache leaf a rank holds is the block ``cache_pspec`` gives it,
    before the steps and after them (some leaf split: the rank never holds
    the whole cache), and its cache and parameter bytes are
    ``rules.shard_bytes``'s, below the whole trees'."""
    for out in _outs(runs, key):
        r = out[key]
        split = 0
        for leaf, (got, rule) in r["blocks"].items():
            assert got == rule == r["after"][leaf], (key, leaf, got, rule)
        split = sum(got != r["cache"][leaf].shape
                    for leaf, (got, _) in r["blocks"].items())
        assert split > 0, key
        held, shard, whole = r["cache_bytes"]
        assert held == shard < whole, (key, r["cache_bytes"])
        held, shard, whole = r["bytes"]
        assert held == shard < whole, (key, r["bytes"])


if __name__ == "__main__":
    _rank_main(pathlib.Path(sys.argv[1]), sys.argv[2])
