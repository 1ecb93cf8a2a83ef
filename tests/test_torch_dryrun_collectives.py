"""The dry-run's collective term and its ``moe_local`` programs on abstract meshes.

* **Counted equals moved.**  Four gloo ranks on the CPU, as ``(data=2,
  model=2)``, each run a step of the smoke configs on its blocks
  (``launch.dryrun.place_cell``, then ``run_step``) under
  ``sharding.collectives.record``; the test process runs the same step
  as rank 0 on fake tensors on the counting mesh
  (``launch.mesh.counting_mesh``, ``launch.dryrun.rank_step_cost``).
  Every rank's log equals the count entry by entry (op, bytes, dtype,
  group size, in order), so every rank's equals every other's: rank 0
  stands for all.  The steps: tinyllama's train step under ``default``,
  ``fsdp`` and ``seq_parallel``, its prefill and a decode step under
  ``default``, ``cache_seq`` and ``infer2d``; moonshot's train and
  decode steps under ``moe_local``, and its global route (each rank's
  block, the experts' entry counts all-gathered over the batch group)
  under ``default`` (train, prefill, decode) and ``fsdp`` (train); a
  decode step each of xLSTM, Hymba and Whisper.
* **The ring model is JAX's.**  ``roofline.wire_bytes`` and
  ``Roofline.from_log`` against ``repro.roofline.parse_collectives`` on an
  HLO line of the same op, shape, dtype and ``replica_groups``, for
  every op at 2, 4 and 16 ranks.
* **The whole ``moe_local`` view matches JAX.**  ``models.moe.
  moe_apply_whole`` (an abstract ``(2, 2)`` mesh, real f32 tensors), and
  the ranks' ``moe_apply_local`` on their blocks, against JAX's
  ``moe_apply_local`` on four forced host devices, at capacity factor
  0.5, where the global route drops other entries (its output differs).
* **The layer's fake FLOPs** on the production mesh are the expert
  products' ``3 * 2 * E * (n_dp * cap) * d * f`` plus the router's.
* **The pricing rule.**  A group within one node of 8 GPUs sends at
  ``link_bw``, one that spans nodes at ``net_bw``; every group of the
  production meshes spans nodes.

The ranks are this file run as a script (no JAX import), meeting through
a ``FileStore``; JAX runs in a subprocess meanwhile.
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
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import roofline as RL
from repro_torch.configs import ShapeConfig, get_config, get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as S
from repro_torch.models import moe as M
from repro_torch.models.api import get_model
from repro_torch.sharding import collectives as C
from repro_torch.sharding import rules
from repro_torch.sharding.context import use_mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
AXES = (("data", 2), ("model", 2))
TC = TrainConfig(optimizer="adamw", lr=3e-4, lr_min=3e-5)
SEQ, BATCH = 16, 4
MOE = "moonshot-v1-16b-a3b"
CF = 0.5                            # drops entries (ROADMAP.md Queue 3)
MOE_B, MOE_T = 4, 8
RTOL = 1e-5
# name -> (arch, config changes, step kinds)
CASES = {
    "default": ("tinyllama-1.1b", {}, ("train", "prefill", "decode")),
    "fsdp": ("tinyllama-1.1b", {"sharding_profile": "fsdp"}, ("train",)),
    "sp": ("tinyllama-1.1b", {"seq_parallel": True}, ("train",)),
    "cache_seq": ("tinyllama-1.1b", {"sharding_profile": "cache_seq"},
                  ("prefill", "decode")),
    "infer2d": ("tinyllama-1.1b", {"sharding_profile": "infer2d"},
                ("prefill", "decode")),
    "moe_local": (MOE, {"sharding_profile": "moe_local"},
                  ("train", "decode")),
    "moe_global": (MOE, {}, ("train", "prefill", "decode")),
    "moe_fsdp": (MOE, {"sharding_profile": "fsdp"}, ("train",)),
    "xlstm": ("xlstm-1.3b", {}, ("decode",)),
    "hymba": ("hymba-1.5b", {}, ("decode",)),
    "whisper": ("whisper-tiny", {}, ("decode",)),
}


def _steps():
    return [(name, kind) for name, (_, _, kinds) in CASES.items()
            for kind in kinds]


def _api(name):
    arch, change, _ = CASES[name]
    return get_model(get_smoke_config(arch).replace(**change))


def _shape(kind):
    return ShapeConfig("smoke", kind, SEQ, BATCH)


def _entries(log):
    return [(c.op, c.bytes, c.dtype, c.group_size) for c in log]


def real_operands(api, shape, seed=0):
    """A cell's operands as real CPU tensors, whole: random weights, token
    ids and frames from numpy, the optimizer state or an empty cache."""
    rng = np.random.default_rng(seed)
    params = api.init(torch.Generator().manual_seed(seed), device="cpu")
    inputs = {}
    for k, spec in api.input_specs(shape).items():
        if k == "pos":
            inputs[k] = torch.tensor(shape.seq_len - 1, dtype=spec.dtype)
        elif spec.dtype == torch.int32:
            inputs[k] = torch.from_numpy(rng.integers(
                0, api.cfg.vocab_size, spec.shape).astype(np.int32))
        else:
            inputs[k] = torch.from_numpy(rng.standard_normal(
                spec.shape).astype(np.float32)).to(spec.dtype)
    out = {"params": params, "inputs": inputs}
    if shape.kind == "train":
        out["opt"] = S.build_train_step(api, TC)[1](params)
    else:
        out["cache"] = api.init_cache(shape.global_batch, shape.seq_len,
                                      device="cpu")
    return out


def moe_inputs(seed=3):
    """moonshot's smoke MoE layer in f32 at capacity factor CF, and x."""
    cfg = get_smoke_config(MOE).replace(dtype="float32", capacity_factor=CF,
                                        sharding_profile="moe_local")
    rng = np.random.default_rng(seed)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    arrays = {"router": rng.standard_normal((d, e)) / np.sqrt(d),
              "gate_w": rng.standard_normal((e, d, f)) / np.sqrt(d),
              "up_w": rng.standard_normal((e, d, f)) / np.sqrt(d),
              "down_w": rng.standard_normal((e, f, d)) / np.sqrt(f),
              "x": rng.standard_normal((MOE_B, MOE_T, d))}
    return cfg, {k: v.astype(np.float32) for k, v in arrays.items()}


def moe_params(arrays):
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    return {"router": {"w": t["router"]}, "gate_w": t["gate_w"],
            "up_w": t["up_w"], "down_w": t["down_w"]}, t["x"]


# --------------------------------------------------------- the ranks --

def _rank_main(work: pathlib.Path) -> None:
    torch.set_num_threads(1)
    dev = mesh_lib.init_distributed(
        "cpu", init_method=f"file://{work}/store")
    mesh = mesh_lib.make_group_mesh(AXES, dev)
    rank = torch.distributed.get_rank()
    out = {"rank": rank, "coords": {a: mesh.coordinate(a)
                                    for a in mesh.axis_names}, "logs": {}}
    for name, kind in _steps():
        api, shape = _api(name), _shape(kind)
        trees = real_operands(api, shape)
        with use_mesh(mesh):
            placed = D.place_cell(api, shape, mesh, trees)
            with C.record() as log:
                D.run_step(api, shape, TC, placed, api.cfg.sharding_profile)
        out["logs"][name, kind] = _entries(log)
    cfg, arrays = moe_inputs()
    p, x = moe_params(arrays)
    local = rules.place(p, rules.params_shardings(p, mesh, "moe_local"))
    with use_mesh(mesh):
        x_block = rules.constrain_batch(x, mesh)
        y, aux = M.moe_apply(local, cfg, x_block)
    out["moe"] = {"y": y, "aux": aux, "experts": local["gate_w"].shape[0]}
    torch.save(out, work / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


# ------------------------------------------------------- JAX's side --

JAX_REF = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.models import moe as JM

z = np.load(sys.argv[1])
cfg = get_smoke_config("moonshot-v1-16b-a3b").replace(
    dtype="float32", capacity_factor=float(z["cf"]),
    sharding_profile="moe_local")
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
p = {"router": {"w": jnp.asarray(z["router"])},
     **{k: jnp.asarray(z[k]) for k in ("gate_w", "up_w", "down_w")}}
y, aux = jax.jit(lambda p, x: JM.moe_apply_local(p, cfg, x, mesh))(
    p, jnp.asarray(z["x"]))
np.savez(sys.argv[2], y=np.asarray(y), aux=np.asarray(aux))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks and JAX's reference run at once; the counting runs
    and the whole view meanwhile, in this process."""
    work = tmp_path_factory.mktemp("dryrun_collectives")
    t0 = time.perf_counter()
    cfg, arrays = moe_inputs()
    np.savez(work / "jax_in.npz", cf=CF, **arrays)
    env = dict(os.environ, PYTHONPATH=str(SRC), WORLD_SIZE="4",
               OMP_NUM_THREADS="1")
    ranks = [subprocess.Popen(
        [sys.executable, __file__, str(work)],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_REF, str(work / "jax_in.npz"),
         str(work / "jax_out.npz")],
        env=dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    counting = mesh_lib.counting_mesh(mesh_lib.Mesh(*zip(*AXES)))
    counted = {(name, kind): D.rank_step_cost(_api(name), _shape(kind), TC,
                                              counting)
               for name, kind in _steps()}
    p, x = moe_params(arrays)
    with use_mesh(mesh_lib.Mesh(*zip(*AXES))):
        whole = M.moe_apply(p, cfg, x)
    glob = M.moe_apply(p, cfg.replace(sharding_profile="default"), x)

    for i, proc in enumerate(ranks + [jax_proc]):
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"process {i} failed:\n{log}"
    out = [torch.load(work / f"rank{r}.pt") for r in range(4)]
    with np.load(work / "jax_out.npz") as z:
        jax_out = {k: z[k] for k in z.files}
    print(f"dryrun_collectives fixture: {time.perf_counter() - t0:.1f} s")
    return dict(ranks=out, counted=counted, whole=whole, glob=glob,
                jax=jax_out)


# ------------------------------------------------------------ checks --

@pytest.mark.parametrize("name,kind", _steps())
def test_counted_equals_moved(runs, name, kind):
    """Each rank's log of the step equals rank 0's count on fake tensors
    on the counting mesh, entry by entry; so all ranks' logs are alike."""
    want = _entries(runs["counted"][name, kind]["log"])
    assert want, "the step issued no collective"
    for out in runs["ranks"]:
        got = out["logs"][name, kind]
        assert got == want, (out["rank"], name, kind)


def test_counted_logs_name_what_moves(runs):
    """The logs use JAX's op names and the dtypes that move: the sums
    of activations all-reduce f32, the bf16 smoke configs gather bf16,
    ``cache_seq``
    and xLSTM's states move by all-to-all, ``fsdp`` and ``infer2d``
    gather over all four ranks; the counting groups hold rank 0's global
    ranks."""
    counted = runs["counted"]
    seen = {c.op for cost in counted.values() for c in cost["log"]}
    assert seen == {"all-reduce", "all-gather", "all-to-all"}
    dtypes = {(c.op, c.dtype) for cost in counted.values()
              for c in cost["log"]}
    assert ("all-reduce", "float32") in dtypes
    assert ("all-gather", "bfloat16") in dtypes
    assert {c.group_size for c in counted["fsdp", "train"]["log"]} >= {4}
    assert any(c.op == "all-to-all" for c in counted["xlstm", "decode"]["log"])
    # the global route's prefix: one [R, E] int64 gather a layer, over
    # the data group (default) or every rank (fsdp's rows)
    cfg = _api("moe_global").cfg
    for name, ranks in (("moe_global", 2), ("moe_fsdp", 4)):
        counts = [c for c in counted[name, "train"]["log"]
                  if c.dtype == "int64"]
        assert [(c.op, c.bytes, c.group_size) for c in counts] == \
            [("all-gather", ranks * cfg.n_experts * 8, ranks)] * \
            cfg.n_layers * (2 if cfg.remat else 1)
    for c in counted["default", "train"]["log"]:
        assert c.ranks in ((0, 1), (0, 2)), c
    for cost in counted.values():
        assert cost["flops"] > 0 and cost["op_bytes"] > 0


def test_ring_model_is_jax():
    from repro.roofline import parse_collectives
    for op in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all"):
        for n in (2, 4, 16):
            for dt, jdt, item in (("float32", "f32", 4),
                                  ("bfloat16", "bf16", 2)):
                dims = (8 * n, 24)
                size = item * dims[0] * dims[1]
                groups = ",".join(str(i) for i in range(n))
                line = (f"  %c = {jdt}[{dims[0]},{dims[1]}]{{1,0}} {op}("
                        f"{jdt}[{dims[0]},{dims[1]}]{{1,0}} %p), "
                        f"replica_groups={{{{{groups}}}}}")
                stats = parse_collectives(line)
                assert stats.by_type == {op: float(size)}, line
                assert RL.wire_bytes(op, size, n) == \
                    pytest.approx(stats.wire_bytes, rel=1e-12), (op, n)
                rl = RL.Roofline.from_log(1.0, 1.0, [C.Collective(
                    op, size, dt, n, tuple(range(n)))])
                assert rl.coll_by_type == stats.by_type
                assert rl.coll_bytes == stats.total_bytes
                assert rl.coll_wire_bytes == \
                    pytest.approx(stats.wire_bytes, rel=1e-12)
    assert RL.wire_bytes("all-reduce", 1024, 1) == 0.0


def test_pricing_by_node():
    hw = RL.H100_SXM_BF16
    assert (hw.link_bw, hw.net_bw, hw.node_size) == (450e9, 50e9, 8)
    size = 2 ** 30

    def t(ranks):
        return RL.Roofline.from_log(0.0, 0.0, [C.Collective(
            "all-reduce", size, "float32", len(ranks), tuple(ranks))]
        ).t_collective
    wire = RL.wire_bytes("all-reduce", size, 8)
    assert t(range(8)) == pytest.approx(wire / hw.link_bw)
    assert t(range(8, 16)) == pytest.approx(wire / hw.link_bw)
    assert t(range(4, 12)) == pytest.approx(wire / hw.net_bw)
    assert t(range(0, 128, 16)) == pytest.approx(wire / hw.net_bw)
    mixed = RL.Roofline.from_log(0.0, 0.0, [
        C.Collective("all-gather", size, "bfloat16", 2, (0, 1)),
        C.Collective("all-gather", size, "bfloat16", 2, (0, 16))])
    half = RL.wire_bytes("all-gather", size, 2)
    assert mixed.coll_wire_bytes_across_nodes == half
    assert mixed.t_collective == pytest.approx(half / hw.link_bw +
                                               half / hw.net_bw)
    assert mixed.bottleneck == "collective"
    # every group of both production meshes spans nodes
    for multi in (False, True):
        mesh = mesh_lib.make_production_mesh(multi_pod=multi, counting=True)
        for axes in ("model", "data", rules.batch_pspec(mesh),
                     rules.full_axes(mesh)):
            g = C.process_group(mesh, axes)
            assert not RL.within_node(g.ranks, hw), (multi, axes)
            assert C.group_size(g) == len(set(g.ranks)) == \
                rules._axis_size(mesh, axes)


def test_whole_moe_local_view_matches_jax(runs):
    """The whole view on an abstract (2, 2) mesh and the four ranks'
    ``moe_apply_local`` against JAX's, at capacity factor 0.5; the
    global route's output differs, so the local capacity ran."""
    want, want_aux = runs["jax"]["y"], float(runs["jax"]["aux"])
    y, aux = runs["whole"]
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(y.numpy(), want, rtol=RTOL,
                               atol=RTOL * scale)
    np.testing.assert_allclose(float(aux), want_aux, rtol=RTOL)
    blocks = {}
    for out in runs["ranks"]:
        assert out["moe"]["experts"] == get_smoke_config(MOE).n_experts // 2
        np.testing.assert_allclose(float(out["moe"]["aux"]), want_aux,
                                   rtol=RTOL)
        blocks.setdefault(out["coords"]["data"], []).append(
            out["moe"]["y"].numpy())
    for same in blocks.values():
        assert np.array_equal(same[0], same[1])
    got = np.concatenate([blocks[i][0] for i in sorted(blocks)])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)
    glob = runs["glob"][0].numpy()
    assert float(np.abs(glob - want).max()) > 100 * RTOL * scale, \
        "the global route's output is the local one's: nothing shows " \
        "which capacity ran"


@pytest.mark.parametrize("arch", [MOE, "llama4-maverick-400b-a17b"])
def test_whole_view_fake_flops(arch):
    """On the single-pod mesh (n_dp = 16, model = 16), at full width: the
    expert products' FLOPs over ``[E, n_dp * cap, d]`` plus the router's,
    forward only."""
    cfg = get_config(arch).replace(sharding_profile="moe_local")
    mesh = mesh_lib.make_production_mesh()
    b, t = 32, 64
    n, n_dp = b * t, 16
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    cap = M.local_capacity(cfg, n // n_dp)
    with FakeTensorMode():
        p = {"router": {"w": torch.empty(d, e)},
             "gate_w": torch.empty(e, d, f, dtype=torch.bfloat16),
             "up_w": torch.empty(e, d, f, dtype=torch.bfloat16),
             "down_w": torch.empty(e, f, d, dtype=torch.bfloat16)}
        x = torch.empty(b, t, d, dtype=torch.bfloat16)
        with use_mesh(mesh), FlopCounterMode(display=False) as fc:
            y, aux = M.moe_apply(p, cfg, x)
    assert tuple(y.shape) == (b, t, d) and y.dtype == torch.bfloat16
    assert fc.get_total_flops() == 3 * 2 * e * (n_dp * cap) * d * f + \
        2 * n * d * e


def test_counting_mesh_cuts_rank_zero_blocks():
    """On a counting mesh a fake batch and a fake parameter are cut to
    rank 0's blocks; on the abstract mesh they stay whole; no process
    group is made."""
    mesh = mesh_lib.make_production_mesh()
    counting = mesh_lib.make_production_mesh(counting=True)
    assert counting == mesh and counting.coordinate("model") == 0
    with FakeTensorMode():
        x = torch.empty(256, 8, device="meta")
        assert rules.constrain_batch(x, mesh) is x
        assert tuple(rules.constrain_batch(x, counting).shape) == (16, 8)
        w = torch.empty(64, 32, device="meta")
        sh = rules.NamedSharding(counting, rules.P(None, "model"))
        blk = rules.place(w, sh)
        assert tuple(blk.shape) == (64, 2)
        assert rules.whole_shape(blk) == (64, 32)
        with C.record() as log:
            g = C.gather(blk, 1, C.process_group(counting, "model"))
            s = C.all_sum(torch.empty(4, dtype=torch.bfloat16),
                          C.process_group(counting, ("data", "model")))
        assert tuple(g.shape) == (64, 32) and s.dtype == torch.bfloat16
    assert _entries(log) == [("all-gather", 64 * 32 * 4, "float32", 16),
                             ("all-reduce", 16, "float32", 256)]
    assert not torch.distributed.is_initialized()


if __name__ == "__main__":
    _rank_main(pathlib.Path(sys.argv[1]))
