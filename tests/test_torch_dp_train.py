"""Data-parallel training over a process group, against ``repro``.

The port's process-group mesh (``launch.mesh.init_distributed`` and
``make_host_mesh``), ``rules.constrain_batch`` on it,
``train/grad_compress.py`` and ``train.train_loop``'s data-parallel step
run in four gloo ranks on the CPU: one spawn for the module, each rank
a fresh interpreter running this file as a script (the ranks import no
JAX), meeting through a ``FileStore`` in a temporary directory.

* The compressed psum: the ranks' reduced tree and each rank's new
  error are held bitwise against JAX's ``make_compressed_psum(("data",))``
  under ``shard_map`` over four host devices (a subprocess with
  ``--xla_force_host_platform_device_count=4``), two calls, on
  JAX's own rounding bits (``jax.random.bits`` of the keys JAX's psum
  splits), handed across.  Any element that differs is listed.
* The data-parallel step: the tinyllama-1.1b smoke config in f32 at a
  global batch of 8.  The 4-rank loss and gradients are held against
  ``jax.value_and_grad`` of JAX's ``loss_fn`` on the whole batch at rtol
  1e-5 and atol 1e-5 of each leaf's max|g| (the ranks sum the blocks'
  float32 gradients in another order), and against the port's
  one-process step.  The updated parameters are held against JAX's
  ``clip_by_global_norm``, ``cosine_lr`` and ``adamw_update`` at rtol
  1e-5 plus, where a near-zero gradient's sign differs between the two
  packages, the first Adam step's ``lr * |s_port - s_jax|`` (as
  ``tests/test_torch_lm_train.py`` holds one step).  The ranks' params
  are bitwise equal after two steps.  With microbatches the metrics are
  the last global microbatch's (its rank blocks at 4 rows, the whole
  microbatch on every rank at 2, which does not divide over 4).
* The global MoE route over the four ranks (moonshot's smoke config in
  f32, capacity factor 0.5): gradients and losses against JAX's
  ``moe_apply_global`` on the whole batch, microbatches included.
* ``launch.train`` under ``torch.distributed.run --standalone
  --nproc-per-node 2 --device cpu``: 3 steps, then the same command after
  a crash that lost step 3's checkpoints resumes bitwise.
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
from repro_torch.sharding.context import use_mesh
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import grad_compress as GC
from repro_torch.train import train_loop as tloop
from repro_torch.tree import leaves_with_paths, tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
WORLD = 4
ARCH = "tinyllama-1.1b"
GB, T = 8, 16                           # global batch, sequence
LR = 3e-4
STEP = 3                                # the schedule step of step one
PSUM_SHAPES = {"a": (64, 33), "b": {"c": (7,), "d": (5, 4, 3)}}
PSUM_CALLS = 2
PSUM_KEY = 7
MICRO = (4, 2)                          # 4 rows divide over 4 ranks; 2 not
MOE = "moonshot-v1-16b-a3b"
CF = 0.5                                # moonshot's capacity factor (drops)


def _tc(microbatch=0):
    return TrainConfig(optimizer="adamw", lr=LR, lr_min=LR / 10, steps=10,
                       batch_size=GB, microbatch=microbatch)


def _moe_cfg():
    return get_smoke_config(MOE).replace(dtype="float32", capacity_factor=CF)


def _batch(toks, labels, i):
    return {"tokens": torch.as_tensor(toks[i]).long(),
            "labels": torch.as_tensor(labels[i]).long()}


# --------------------------------------------------------- the ranks --

def _rank_main(work: pathlib.Path) -> None:
    """One rank: every rank-side check, written to ``rank<r>.pt``."""
    torch.set_num_threads(1)
    dev = mesh_lib.init_distributed("cpu",
                                    init_method=f"file://{work}/store")
    mesh = mesh_lib.make_host_mesh(dev)
    r = mesh.coordinate("data")
    inp = torch.load(work / "inputs.pt")
    out = {"rank": r, "mesh": (mesh.axis_names, mesh.axis_sizes),
           "blocks": [rules.constrain_batch(x, mesh) for x in
                      (torch.arange(24).reshape(8, 3), torch.arange(6),
                       torch.tensor(5))]}

    psum = GC.make_compressed_psum(("data",), mesh)
    out["psum"] = []
    for c in range(PSUM_CALLS):
        red, errs = psum(*(tree_map(lambda x: x[c, r], inp[k]) for k in
                           ("psum_grads", "psum_errs", "psum_bits")))
        out["psum"].append({"reduced": red, "errs": errs})

    api = get_model(get_smoke_config(ARCH).replace(dtype="float32"))
    params = inp["params"]
    b0, b1 = (_batch(inp["toks"], inp["labels"], i) for i in (0, 1))
    _, g = tloop.value_and_grad(
        api.loss_fn, params, {k: rules.constrain_batch(v, mesh)
                              for k, v in b0.items()})
    out["grads"] = tloop.group_mean(g, mesh)
    step, init_opt = tloop.build_accumulating_step(api, _tc(), mesh)
    p1, o1, m1 = step(params, init_opt(params), b0, STEP)
    p2, _, m2 = step(p1, o1, b1, STEP + 1)
    out.update(p1=p1, m1=m1, p2=p2, m2=m2)
    for mb in MICRO:
        step, _ = tloop.build_accumulating_step(api, _tc(mb), mesh)
        out[f"micro{mb}"] = step(params, init_opt(params), b0, STEP)[2]
    with use_mesh(mesh):
        step, _ = tsteps.build_train_step(api, _tc())
        out["steps_p1"] = step(params, init_opt(params), b0, STEP)[0]
    # the global MoE route over the four blocks of the batch
    moe = get_model(_moe_cfg())
    mp = inp["moe_params"]
    mb = _batch(inp["moe_toks"], inp["moe_labels"], 0)
    with use_mesh(mesh):
        _, g = tloop.value_and_grad(moe.loss_fn, mp, {
            k: rules.constrain_batch(v, mesh) for k, v in mb.items()})
    out["moe_grads"] = tloop.group_mean(g, mesh)
    step, init_opt = tloop.build_accumulating_step(moe, _tc(), mesh)
    out["moe_m1"] = step(mp, init_opt(mp), mb, STEP)[2]
    for n in MICRO:
        step, _ = tloop.build_accumulating_step(moe, _tc(n), mesh)
        out[f"moe_micro{n}"] = step(mp, init_opt(mp), mb, STEP)[2]
    # a prefill of one sequence: whole on every rank, one block
    with use_mesh(mesh):
        out["moe_prefill1"] = tsteps.build_prefill_step(moe)(
            mp, {"tokens": mb["tokens"][:1]},
            moe.init_cache(1, T, device="cpu"))[0]
    torch.save(out, work / f"rank{r}.pt")
    torch.distributed.destroy_process_group()


# ----------------------------------------------------- JAX's psum --

JAX_PSUM = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.train import grad_compress as GC
z = np.load(sys.argv[1])
paths = [k[2:] for k in z.files if k.startswith("g:")]
mesh = jax.make_mesh((4,), ("data",))
psum8 = GC.make_compressed_psum(("data",))

def body(g, e, k):
    red, err = psum8({p: g[p][0] for p in g}, {p: e[p][0] for p in e}, k[0])
    return red, {p: v[None] for p, v in err.items()}
fn = jax.jit(compat.shard_map(body, mesh=mesh, in_specs=(P("data"),) * 3,
                              out_specs=(P(), P("data"))))
keys = jax.random.split(jax.random.PRNGKey(int(z["key"])), 4)
out = {}
for c in range(int(z["calls"])):
    red, errs = fn({p: jnp.asarray(z["g:" + p][c]) for p in paths},
                   {p: jnp.asarray(z["e:" + p][c]) for p in paths},
                   jax.random.split(keys[c], 4) if c else keys)
    for p in paths:
        out[f"r{c}:{p}"] = np.asarray(red[p])
        out[f"e{c}:{p}"] = np.asarray(errs[p])
np.savez(sys.argv[2], **out)
"""


def _psum_keys(jax, c):
    """The per-device keys of psum call ``c`` in ``JAX_PSUM``."""
    keys = jax.random.split(jax.random.PRNGKey(PSUM_KEY), WORLD)
    return keys if c == 0 else jax.random.split(keys[c], WORLD)


def _psum_bits(jax, shapes_flat):
    """[calls, WORLD] bits a leaf: what JAX's ``psum_int8`` draws on each
    device (``jax.random.split`` of the device's key, one key a leaf, in
    tree order)."""
    import jax.numpy as jnp
    out = {p: np.zeros((PSUM_CALLS, WORLD) + s, np.int64)
           for p, s in shapes_flat}
    for c in range(PSUM_CALLS):
        for d, key in enumerate(_psum_keys(jax, c)):
            ks = jax.random.split(key, len(shapes_flat))
            for i, (p, s) in enumerate(shapes_flat):
                out[p][c, d] = np.asarray(jax.random.bits(ks[i], s,
                                                          jnp.uint32))
    return out


def _nest(flat):
    """{"b/c": x} -> {"b": {"c": x}}."""
    tree = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _spawn_ranks(work: pathlib.Path):
    env = dict(os.environ, PYTHONPATH=str(SRC), WORLD_SIZE=str(WORLD),
               OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, __file__, str(work)],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]


def _join(proc, what: str, timeout: float = 120):
    out, _ = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, f"{what} failed:\n{out}"
    return out


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Inputs drawn, the four ranks and JAX's psum run at once, and JAX's
    and the port's one-process references computed meanwhile."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke
    from repro.configs.base import TrainConfig as JaxTrainConfig
    from repro.models import transformer as JT
    from repro.models.api import get_model as jax_get_model
    from repro.train import optimizer as jopt

    work = tmp_path_factory.mktemp("dp")
    t0 = time.perf_counter()
    jcfg = jax_smoke(ARCH).replace(dtype="float32")
    jparams = jax.jit(JT.lm_init, static_argnums=1)(jax.random.PRNGKey(0),
                                                     jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (2, GB, T)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (2, GB, T)).astype(np.int32)

    mcfg = jax_smoke(MOE).replace(dtype="float32", capacity_factor=CF)
    moe_api = jax_get_model(mcfg)
    np_moe = jax.tree_util.tree_map(np.asarray, jax.jit(moe_api.init)(
        jax.random.PRNGKey(1)))
    moe_toks = rng.integers(0, mcfg.vocab_size, (1, GB, T)).astype(np.int32)
    moe_labels = rng.integers(0, mcfg.vocab_size, (1, GB, T)
                              ).astype(np.int32)

    flat_shapes = [("/".join(p), s) for p, s in _shape_items(PSUM_SHAPES)]
    g = {p: (rng.standard_normal((PSUM_CALLS, WORLD) + s) * 0.01
             ).astype(np.float32) for p, s in flat_shapes}
    e = {p: (rng.standard_normal((PSUM_CALLS, WORLD) + s) * 1e-4
             ).astype(np.float32) for p, s in flat_shapes}
    bits = _psum_bits(jax, flat_shapes)
    np.savez(work / "psum_in.npz", key=PSUM_KEY, calls=PSUM_CALLS,
             **{"g:" + p: v for p, v in g.items()},
             **{"e:" + p: v for p, v in e.items()})
    torch.save({"params": from_numpy_tree(np_params),
                "moe_params": from_numpy_tree(np_moe),
                "moe_toks": torch.from_numpy(moe_toks),
                "moe_labels": torch.from_numpy(moe_labels),
                "toks": torch.from_numpy(toks),
                "labels": torch.from_numpy(labels),
                "psum_grads": _nest({p: torch.from_numpy(v)
                                     for p, v in g.items()}),
                "psum_errs": _nest({p: torch.from_numpy(v)
                                    for p, v in e.items()}),
                "psum_bits": _nest({p: torch.from_numpy(v)
                                    for p, v in bits.items()})},
               work / "inputs.pt")
    ranks = _spawn_ranks(work)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_PSUM, str(work / "psum_in.npz"),
         str(work / "psum_jax.npz")],
        env=dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    # JAX's step, composed from its parts on the whole global batch
    jtc = JaxTrainConfig(optimizer="adamw", lr=LR, lr_min=LR / 10,
                         steps=10)
    j_init, j_upd = jopt.get_optimizer(jtc)
    loss_fn = jax_get_model(jcfg).loss_fn

    @jax.jit
    def jax_step(params, batch, step):
        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, batch)
        clipped, gnorm = jopt.clip_by_global_norm(grads, 1.0)
        lr = jopt.cosine_lr(step, jtc)
        new, _ = j_upd(clipped, j_init(params), params, lr, jtc)
        return metrics, grads, gnorm, new

    def jbatch(rows, i=0):
        return {"tokens": jnp.asarray(toks[i][rows]),
                "labels": jnp.asarray(labels[i][rows])}
    jm, jg, jn, jp1 = jax_step(jparams, jbatch(slice(None)),
                               jnp.asarray(STEP, jnp.int32))
    jax_loss_fn = jax.jit(loss_fn)
    micro_loss = {mb: float(jax_loss_fn(jparams, jbatch(slice(GB - mb,
                                                              GB)))[0])
                  for mb in MICRO}
    # JAX's global MoE route on the whole batch, and on each microbatch
    moe_vg = jax.jit(jax.value_and_grad(moe_api.loss_fn, has_aux=True))

    def moe_batch(rows):
        return {"tokens": jnp.asarray(moe_toks[0][rows]),
                "labels": jnp.asarray(moe_labels[0][rows])}
    (moe_loss, _), moe_g = moe_vg(np_moe, moe_batch(slice(None)))
    moe_micro = {mb: float(moe_vg(np_moe, moe_batch(slice(GB - mb, GB)))
                           [0][0]) for mb in MICRO}
    moe_prefill1 = np.asarray(jax.jit(moe_api.prefill)(
        np_moe, {"tokens": moe_batch(slice(0, 1))["tokens"]},
        moe_api.init_cache(1, T))[0])

    # the port's one-process step
    api = get_model(get_smoke_config(ARCH).replace(dtype="float32"))
    params = from_numpy_tree(np_params)
    step, init_opt = tloop.build_accumulating_step(api, _tc())
    (_, m), port_grads = tloop.value_and_grad(api.loss_fn, params,
                                              _batch(toks, labels, 0))
    q1, o1, n1 = step(params, init_opt(params), _batch(toks, labels, 0),
                      STEP)
    _, _, n2 = step(q1, o1, _batch(toks, labels, 1), STEP + 1)

    outs = [_join(p, f"rank {r}") for r, p in enumerate(ranks)]
    _join(jax_proc, "JAX's compressed psum")
    got = [torch.load(work / f"rank{r}.pt") for r in range(WORLD)]
    z = np.load(work / "psum_jax.npz")
    print(f"dp fixture: {time.perf_counter() - t0:.1f} s")
    return dict(
        ranks=got, rank_logs=outs, flat_shapes=flat_shapes, psum_jax=z,
        psum_grads=g, psum_errs=e,
        jax=dict(loss=float(jm["loss"]), gnorm=float(jn),
                 grads={"/".join(map(str, p)): np.asarray(v) for p, v in
                        leaves_with_paths(jax.tree_util.tree_map(
                            np.asarray, jg))},
                 p1={"/".join(map(str, p)): np.asarray(v) for p, v in
                     leaves_with_paths(jax.tree_util.tree_map(np.asarray,
                                                              jp1))},
                 micro_loss=micro_loss, moe_loss=float(moe_loss),
                 moe_grads={"/".join(map(str, p)): np.asarray(v)
                            for p, v in leaves_with_paths(
                                jax.tree_util.tree_map(np.asarray, moe_g))},
                 moe_micro=moe_micro, moe_prefill1=moe_prefill1),
        port=dict(loss=float(m["loss"]), grads=port_grads, m1=n1, m2=n2),
        params=np_params)


def _shape_items(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _shape_items(tree[k], path + (k,))
    else:
        yield path, tree


def _flat(tree):
    return {"/".join(map(str, p)): v.detach().numpy()
            for p, v in leaves_with_paths(tree)}


def _differing(got, want, where):
    """Each element where ``got`` and ``want`` differ, listed."""
    bad = np.argwhere(got.view(np.uint32) != want.view(np.uint32))
    return [f"{where}{tuple(i)}: {got[tuple(i)]!r} != {want[tuple(i)]!r}"
            for i in bad]


# ------------------------------------------------------------ tests --

def test_process_group_mesh(dp):
    for r, out in enumerate(dp["ranks"]):
        assert out["rank"] == r
        assert out["mesh"] == (("data",), (WORLD,))


def test_constrain_batch_gives_each_rank_its_block(dp):
    x = torch.arange(24).reshape(8, 3)
    for r, out in enumerate(dp["ranks"]):
        block, whole, scalar = out["blocks"]
        assert torch.equal(block, x[2 * r:2 * r + 2])
        assert torch.equal(whole, torch.arange(6))     # 6 % 4: not split
        assert torch.equal(scalar, torch.tensor(5))


def test_compressed_psum_is_jax_bitwise(dp):
    """The reduced tree bitwise JAX's on every rank; each rank's new
    error ``gf - q * scale`` bitwise JAX's but for the elements listed.
    The port rounds it once, as XLA's CPU code fuses the product into the
    subtraction; XLA leaves some lanes unfused (here the last of a 3-wide
    minor dim), and each listed element must be that unfused rounding,
    ``fl(gf - fl(q * scale))``, of the port's own ``q`` and scale."""
    z, diffs, unfused = dp["psum_jax"], [], []
    recip = np.float32(1.0 / 127.0)
    for c in range(PSUM_CALLS):
        for p, _ in dp["flat_shapes"]:
            gf = dp["psum_grads"][p][c] + dp["psum_errs"][p][c]
            scale = np.float32(np.abs(gf).max()) * recip
            for r, out in enumerate(dp["ranks"]):
                red = _flat(out["psum"][c]["reduced"])[p]
                err = _flat(out["psum"][c]["errs"])[p]
                want = z[f"e{c}:{p}"][r]
                diffs += _differing(red, z[f"r{c}:{p}"],
                                    f"call {c} rank {r} reduced {p}")
                q = np.rint((gf[r].astype(np.float64) - err) / scale)
                split = (gf[r] - (q * scale).astype(np.float32)
                         ).astype(np.float32)
                for i in np.argwhere(err.view(np.uint32) !=
                                     want.view(np.uint32)):
                    i = tuple(i)
                    line = (f"call {c} rank {r} error {p}{i}: "
                            f"{err[i]!r} != {want[i]!r}")
                    if split[i] == want[i]:
                        unfused.append(line)
                    else:
                        diffs.append(line + f" (unfused {split[i]!r})")
    n = PSUM_CALLS * WORLD * sum(np.prod(s) for _, s in dp["flat_shapes"])
    print(f"compressed psum: {len(unfused)} of {n} error elements are "
          f"XLA's unfused rounding:")
    print("\n".join(unfused))
    assert not diffs, "\n".join(diffs[:50]) + f"\n({len(diffs)} in all)"


def test_compressed_psum_error_feedback_tracks_the_sum():
    """``tests/test_train_infra.py``'s check on the port, with bits from
    numpy and no group (the collectives are the identity): over 50
    steps the reduced sum stays within 2% of the true sum."""
    rng = np.random.default_rng(1)
    psum8 = GC.make_compressed_psum(("data",))
    g = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32)
                         * 0.01)
    err = GC.init_error_state({"w": g})
    total_true = torch.zeros(64, 64)
    total_comp = torch.zeros(64, 64)
    for _ in range(50):
        gs = {"w": g + 0.001 * torch.from_numpy(
            rng.standard_normal((64, 64)).astype(np.float32))}
        bits = {"w": torch.from_numpy(rng.integers(
            0, 2 ** 32, (64, 64), dtype=np.uint64).astype(np.int64))}
        red, err = psum8(gs, err, bits)
        total_true += gs["w"]
        total_comp += red["w"]
    rel = float(torch.linalg.norm(total_comp - total_true) /
                torch.linalg.norm(total_true))
    assert rel < 0.02, rel


def test_wire_bytes_and_error_state_are_jax_s():
    import jax.numpy as jnp

    from repro.train import grad_compress as JGC
    tree = {"w": torch.zeros(1000, 1000), "b": [torch.zeros(7),
                                               torch.zeros(3, 2)]}
    jtree = {"w": jnp.zeros((1000, 1000)), "b": [jnp.zeros(7),
                                                 jnp.zeros((3, 2))]}
    assert GC.compression_wire_bytes(tree) == \
        JGC.compression_wire_bytes(jtree)
    got, want = GC.init_error_state(tree), JGC.init_error_state(jtree)
    for (p, a), (_, b) in zip(leaves_with_paths(got),
                              leaves_with_paths(want)):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, p
        assert not a.any()


def test_no_group_psum_refuses_an_abstract_axis():
    psum8 = GC.make_compressed_psum(("data",),
                                    mesh_lib.Mesh(("data",), (4,)))
    g = {"w": torch.zeros(3)}
    with pytest.raises(NotImplementedError, match="process group"):
        psum8(g, g, {"w": torch.zeros(3, dtype=torch.int64)})


def _close(got, want, what, rtol=1e-5):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5 * scale,
                               err_msg=what)


def test_dp_loss_and_gradients_match_jax(dp):
    j = dp["jax"]
    for out in dp["ranks"]:
        np.testing.assert_allclose(float(out["m1"]["loss"]), j["loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(float(out["m1"]["grad_norm"]),
                                   j["gnorm"], rtol=1e-5)
        grads = _flat(out["grads"])
        assert grads.keys() == j["grads"].keys()
        for p, want in j["grads"].items():
            _close(grads[p], want, p)


def test_dp_matches_the_one_process_step(dp):
    port = dp["port"]
    want = _flat(port["grads"])
    for out in dp["ranks"]:
        for p, g in _flat(out["grads"]).items():
            _close(g, want[p], p)
        for k in ("m1", "m2"):
            for name in ("loss", "ce", "grad_norm", "lr"):
                np.testing.assert_allclose(float(out[k][name]),
                                           float(port[k][name]), rtol=1e-5,
                                           err_msg=f"{k} {name}")


def test_dp_updated_params_match_jax_parts(dp):
    """One AdamW step: rtol 1e-5, and ``lr |s_port - s_jax|`` where the
    first Adam step ``g / (|g| + eps)`` of the two packages' clipped
    gradients differs (a near-zero gradient's sign)."""
    j, eps = dp["jax"], 1e-8
    other_way = 0
    for out in dp["ranks"]:
        got, grads = _flat(out["p1"]), _flat(out["grads"])
        gnorm = float(out["m1"]["grad_norm"])
        for p, w in j["p1"].items():
            s_t = grads[p] * min(1.0, 1.0 / (gnorm + 1e-9))
            s_j = j["grads"][p] * min(1.0, 1.0 / (j["gnorm"] + 1e-9))
            s_t, s_j = s_t / (np.abs(s_t) + eps), s_j / (np.abs(s_j) + eps)
            other_way += int((np.sign(s_t) != np.sign(s_j)).sum())
            allowed = 1e-5 * np.abs(w) + LR * np.abs(s_t - s_j) + 1e-6 * LR
            err = np.abs(got[p] - w)
            assert np.all(err <= allowed), (p, float(err.max()))
    print(f"4-rank AdamW step: {other_way} elements moved the other way")


def test_ranks_params_bitwise_equal_after_two_steps(dp):
    first = _flat(dp["ranks"][0]["p2"])
    for out in dp["ranks"][1:]:
        for p, v in _flat(out["p2"]).items():
            assert np.array_equal(v, first[p]), p
        assert float(out["m2"]["loss"]) == float(dp["ranks"][0]["m2"]["loss"])


def test_build_train_step_reduces_as_fit_does(dp):
    """``launch.steps.build_train_step`` under the group mesh (current)
    is bitwise ``build_accumulating_step`` on it."""
    for out in dp["ranks"]:
        want = _flat(out["p1"])
        for p, v in _flat(out["steps_p1"]).items():
            assert np.array_equal(v, want[p]), p


@pytest.mark.parametrize("mb", MICRO)
def test_microbatch_metrics_are_the_last_global_microbatch(dp, mb):
    want = dp["jax"]["micro_loss"][mb]
    for out in dp["ranks"]:
        np.testing.assert_allclose(float(out[f"micro{mb}"]["loss"]), want,
                                   rtol=1e-5)


def test_moe_data_parallel_is_refused(dp):
    """No longer refused (the name is kept from when it pinned the
    refusal): the global MoE route over four data ranks (moonshot's
    smoke config in f32 at capacity factor 0.5, where entries drop),
    each rank routing its block after the earlier blocks' entry counts
    (``models/moe.py``); the averaged gradients, one step's
    loss, and the loss of the last microbatch at 4 rows (a row a rank)
    and at 2 (which does not divide over 4: every rank takes the whole
    microbatch as one block) against JAX's ``moe_apply_global`` on the
    whole batch, at rtol 1e-5."""
    j = dp["jax"]
    for out in dp["ranks"]:
        np.testing.assert_allclose(float(out["moe_m1"]["loss"]),
                                   j["moe_loss"], rtol=1e-5)
        grads = _flat(out["moe_grads"])
        assert grads.keys() == j["moe_grads"].keys()
        for p, want in j["moe_grads"].items():
            _close(grads[p], want, f"moe {p}")
        for mb in MICRO:
            np.testing.assert_allclose(float(out[f"moe_micro{mb}"]["loss"]),
                                       j["moe_micro"][mb], rtol=1e-5,
                                       err_msg=f"microbatch {mb}")


def test_moe_serves_an_undivided_batch_whole(dp):
    """A prefill of one sequence over four data ranks does not divide:
    every rank takes the whole batch as its one block (``rules.Placement.
    for_batch``), and the global MoE route its whole capacity, as JAX's
    one program; the logits within rtol 1e-5 of JAX's."""
    want = dp["jax"]["moe_prefill1"]
    for out in dp["ranks"]:
        _close(out["moe_prefill1"].numpy(), want, "one-row prefill")


def test_nccl_without_a_gpu_raises(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"device": "cpu", "backend": "nccl"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_lib.init_distributed(**kw)


def test_without_torchrun_there_is_no_group(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh_lib.init_distributed("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    host = mesh_lib.make_host_mesh("cpu")
    assert host == mesh_lib.Mesh(("data",), (1,)) and \
        host.device_mesh is None
    assert mesh_lib.process_group(host, "data") is None and \
        mesh_lib.process_group(None, "data") is None


# ------------------------------------------------- launch.train --

def _torchrun(args, what):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
           *args]
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=180)
    assert proc.returncode == 0, f"{what}:\n{proc.stdout}\n{proc.stderr}"
    return proc.stdout


def test_launch_train_under_torchrun_resumes_bitwise(tmp_path):
    ckpt = tmp_path / "ckpt"
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3",
            "--batch", "4", "--seq", "16", "--grad-compress-bits", "8",
            "--ckpt-dir", str(ckpt)]
    out = _torchrun(argv, "straight run")
    assert out.count("done: loss") == 1 and "(step 2)" in out
    assert tckpt.latest_step(str(ckpt)) == 3
    kept = tmp_path / "step3"
    shutil.copytree(ckpt / "step_00000003", kept)
    for d in (ckpt, ckpt / "opt"):
        shutil.rmtree(d / "step_00000003")
    out = _torchrun(argv, "resumed run")
    assert out.count("done: loss") == 1 and "(step 2)" in out and \
        "(step 0)" not in out
    with np.load(kept / "shards_host0.npz") as a, \
            np.load(ckpt / "step_00000003" / "shards_host0.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k


if __name__ == "__main__":
    _rank_main(pathlib.Path(sys.argv[1]))
