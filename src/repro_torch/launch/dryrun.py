"""Multi-pod dry-run: every (arch x shape) cell's step, counted on fake
tensors and placed on the production meshes, on any host.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
      [--shape train_4k] [--mesh pod|multipod|both] [--profile default] \\
      [--variant NAME] [--fast] [--out artifacts/dryrun_torch]

Emits one JSON per cell, ``<out>/<mesh>/<arch>/<shape>[.<profile>].json``,
with ``repro.launch.dryrun``'s keys; ``python -m repro_torch.report``
renders them.  Skips come from ``configs.cell_is_runnable``.

The port of ``repro.launch.dryrun``.  JAX lowers and compiles each cell
for a 256- or 512-device mesh on a fake host platform and reads XLA's
memory and cost analyses and the HLO's collectives.  The port has no
compiler.  It runs the same step (``launch.steps``: loss, backward, clip
and AdamW update to train; prefill; one decode step) eagerly, at the
cell's global shape and full depth, on fake tensors (``FakeTensorMode``
on the ``meta`` device: nothing is allocated; ``launch.steps`` says why
``meta``), under the cell's mesh (``sharding.context``), and counts:

* ``memory.argument_size_in_bytes``: per device, exact: the rules' local
  shard shapes (``sharding.rules``) of the params, the inputs and the
  optimizer state or the cache;
* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the step;
* HBM bytes: for every aten op that allocates or writes (a view moves
  nothing), the sizes of its device tensor arguments and results: the
  eager program's traffic;
* ``memory.temp_size_in_bytes``: the peak of the live bytes of the
  device storages the step allocates, above its arguments, each rounded
  up to 512 bytes as the CUDA caching allocator rounds (storage
  finalizers), plus the buffers a CUDA kernel allocates and frees inside
  one op (:data:`KERNEL_WORKSPACE`, measured on an H100: no op sees
  them, and the softmax backward's set the peak of a training step).
  The step's results count: an eager step donates nothing, so
  ``alias_size_in_bytes`` is 0.

FLOPs, HBM bytes and temp bytes are global counts divided by the device
count: they assume an ideal partition, each device doing 1/n of the
work.  The fake program does not depend on which production mesh is
current (a constraint on a fake tensor is the identity on an abstract
mesh), so both meshes of a cell share one count in a process.

The collective term comes from a second run of the step (:func:`
rank_step_cost`): rank 0's own program, on the cell's counting mesh
(``launch.mesh.make_production_mesh(counting=True)``: the abstract mesh
acting as rank 0 of a process group), on fake tensors cut to rank 0's
blocks by the profile's rules (``rules.place``), under
``sharding.collectives.record``.  It is the program a rank of a
process-group mesh runs (``train_loop.placement``,
``launch.steps.serve_placement``, every collective of the models, the
backward's and the data group's gradient mean), so its log is what each
rank sends: the programs are SPMD, so rank 0 stands for every rank.
``roofline.Roofline.from_log`` prices it (JAX's ring model; a group
within one node of 8 GPUs at NVLink's rate, any other at the network's:
every group of both production meshes spans nodes).  The record keeps
rank 0's own FLOPs and op bytes from that run as ``rank_cost``, beside
the ideal partition's.  This run differs by mesh (the data group has 16
or 32 ranks), so it is counted once a mesh.  The MoE archs' global
route (``default``, ``fsdp``) runs there as on a real group: each rank
routes its block and all-gathers the experts' entry counts over the
batch group (``models/moe.py``).

Eager counting visits every layer, so JAX's unrolled lowerings and their
extrapolation over the depth have no counterpart: JAX's
``_FULL_UNROLL_MAX_LAYERS`` and ``--extrap`` are gone, and
:func:`_with_layers` stays for callers that cut the depth
(``chip_smoke.py``'s card check).  xLSTM's train and prefill cells
(:func:`slow_cell`) run its sLSTM cell once a time step, about 50 fake
ops a step and block, and a fake op costs 0.1-0.3 ms on the host: a
1024-token prefill at full width takes about 75 s, so ``train_4k`` takes
minutes and ``prefill_32k`` most of an hour.  They are counted only
with ``--slow-cells``; without it their record says ``status:
"deferred"`` and why.  (Counting them at two sequence lengths and
extrapolating is not exact: the op bytes of a training step and the
temp peak are not affine in T.)  ``--fast`` writes the shardings'
argument bytes only, with no fake step and no collective term.  A
``moe_local*`` profile on an MoE arch takes JAX's ``moe_apply_local``:
in the ideal partition's run its whole view (``models.moe.
moe_apply_whole``), in rank 0's run the per-rank dispatch.  The flash
route raises on fake tensors; every JAX config and variant takes
``xla`` or ``xla_chunked``.  The serving variants ``w8_2d``,
``infer2d``, ``cache_seq`` and ``w8_cache_seq`` change the placements
(argument bytes) and rank 0's program (``launch.steps.
serve_placement``: ``cache_seq``'s distributed softmax over position
blocks, ``infer2d``'s gathered layers), not the ideal partition's.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import pathlib
import threading
import time
import traceback
import weakref
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import roofline as RL
from repro_torch.configs import (LM_SHAPES, cell_is_runnable, get_config,
                                 list_archs)
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.api import get_model
from repro_torch.sharding import collectives as C
from repro_torch.sharding import rules
from repro_torch.sharding.context import use_mesh
from repro_torch.tree import leaves_with_paths

#: What the CUDA caching allocator rounds each block up to.
ALLOC_ROUND = 512


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _copies(*ts: torch.Tensor) -> int:
    """Bytes of the contiguous copies a kernel makes of its arguments."""
    return sum(_nbytes(t) for t in ts if not t.is_contiguous())


#: Device bytes PyTorch's CUDA kernel for an op allocates and frees
#: within the op, from its tensor arguments (measured on an NVIDIA H100
#: 80GB HBM3 with torch 2.11, ``max_memory_allocated`` around single
#: calls): the softmax backward keeps a buffer the size of its result
#: and copies a non-contiguous grad or output; the softmax copies a
#: non-contiguous input; ``logsumexp`` keeps ``exp(x - max)`` at x's
#: size.  Other ops the steps run allocate nothing inside at their
#: shapes, or less than the peak's resolution.
KERNEL_WORKSPACE = {
    torch.ops.aten._softmax_backward_data.default:
        lambda grad, out, *_: _nbytes(grad) + _copies(grad, out),
    torch.ops.aten._softmax.default: lambda x, *_: _copies(x),
    torch.ops.aten.logsumexp.default: lambda x, *_: _nbytes(x),
}


def _tree_param_counts(shape_tree, cfg):
    """(total, active, embed_table) param counts from a shape tree."""
    total = active = embed = 0
    frac = (cfg.experts_per_token / cfg.n_experts) if cfg.n_experts else 1.0
    for path, leaf in leaves_with_paths(shape_tree):
        keys = rules.path_keys(path)
        n = math.prod(leaf.shape)
        total += n
        if "table" in keys and not cfg.tie_embeddings:
            embed += n
            continue
        if any(k in ("gate_w", "up_w", "down_w") for k in keys):
            active += int(n * frac)
        else:
            active += n
    return total, active, embed


def _layer_unit(cfg) -> int:
    """Smallest coherent layer-count quantum (xLSTM: one 7m+1s group)."""
    return cfg.slstm_every if cfg.slstm_every > 0 else 1


def _with_layers(cfg, n: int):
    kw = {"n_layers": n}
    if cfg.family == "audio":
        kw["n_enc_layers"] = max(1, n * cfg.n_enc_layers // cfg.n_layers)
    return cfg.replace(**kw)


# §Perf hillclimb variants: named config deltas applied on top of the
# baseline (the paper-faithful defaults), as JAX's.
VARIANTS = {
    "sp": dict(seq_parallel=True),
    "chunked": dict(attn_impl="xla_chunked"),
    "sp_chunked": dict(seq_parallel=True, attn_impl="xla_chunked"),
    "moe_local": dict(sharding_profile="moe_local"),
    "moe_local_sp": dict(sharding_profile="moe_local", seq_parallel=True,
                         attn_impl="xla_chunked"),
    "moe_local_chunked": dict(sharding_profile="moe_local",
                              attn_impl="xla_chunked"),
    "fsdp_chunked": dict(sharding_profile="fsdp",
                         attn_impl="xla_chunked"),
    "w8": dict(quant="W8"),           # int8 weights (decode cells)
    "w8_2d": dict(quant="W8", sharding_profile="infer2d"),
    "infer2d": dict(sharding_profile="infer2d"),
    "cache_seq": dict(sharding_profile="cache_seq"),
    "w8_cache_seq": dict(quant="W8", sharding_profile="cache_seq"),
}


def apply_variant(cfg, variant):
    kw = dict(VARIANTS[variant])
    if kw.pop("quant", None) == "W8":
        from repro_torch.core.quant import QuantConfig
        kw["quant"] = QuantConfig(w_bits=8, a_bits=16, backend="int8_ref")
    return cfg.replace(**kw)


# ------------------------------------------------------------ counting --

class Traffic(TorchDispatchMode):
    """Counts, over the aten ops run in the mode, the bytes moved (for an
    op that allocates or writes, its device tensor arguments' and
    results' sizes; a view, or an op that hands back its arguments'
    storages unwritten, moves nothing) and the live bytes of the device
    storages the ops allocate (``peak``: their most at once, with each
    op's :data:`KERNEL_WORKSPACE` on top while it runs).  CPU tensors
    (host scalars) count for neither."""

    def __init__(self):
        super().__init__()
        self.op_bytes = 0
        self.live = 0
        self.peak = 0
        self._lock = threading.Lock()
        self._seen = WeakIdKeyDictionary()

    def _free(self, n: int) -> None:
        with self._lock:
            self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor) and t.device.type != "cpu"]
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor) and t.device.type != "cpu"]
        in_st = [t.untyped_storage() for t in ins]
        fresh = [t for t in outs
                 if not any(t.untyped_storage() is s for s in in_st)]
        moved = (sum(_nbytes(t) for t in ins + outs)
                 if fresh or func._schema.is_mutable else 0)
        new = []
        for t in fresh:
            st = t.untyped_storage()
            if st not in self._seen:
                self._seen[st] = True
                new.append((st, -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND))
        workspace = KERNEL_WORKSPACE.get(func)
        extra = workspace(*args) if workspace is not None and ins else 0
        with self._lock:
            self.op_bytes += moved
            self.live += sum(n for _, n in new)
            # the kernel's own buffers and its results are live at once
            self.peak = max(self.peak, self.live + extra)
        for st, n in new:
            weakref.finalize(st, self._free, n)
        return out


def run_step(api, shape: ShapeConfig, tc: TrainConfig, trees: Dict[str, Any],
             profile: str = "default"):
    """The cell's step on its operands (``launch.steps``), its train or
    prefill step placed by ``profile``'s rules (a decode step by
    ``api.cfg.sharding_profile``'s, as JAX's)."""
    if shape.kind == "train":
        step, _ = S.build_train_step(api, tc, profile)
        return step(trees["params"], trees["opt"], trees["inputs"], 0)
    if shape.kind == "prefill":
        return S.build_prefill_step(api, profile)(
            trees["params"], trees["inputs"], trees["cache"])
    return S.build_decode_step(api)(trees["params"], trees["inputs"],
                                    trees["cache"])


def _operands(api, shape: ShapeConfig, tc: TrainConfig, operands):
    if operands is not None:
        return operands
    mode = S.fake_mode()
    return mode, S.shape_trees(api, shape, tc, mode)


def fake_step_cost(api, shape: ShapeConfig, tc: TrainConfig, operands=None
                   ) -> Dict[str, float]:
    """Global counts of the cell's step on fake tensors (under whatever
    mesh is current): FLOPs, op bytes, the peak of live bytes above the
    arguments (the step's results live at the end) and the seconds the
    count took.  ``operands``: (a fake mode, :func:`launch.steps.
    shape_trees` made in it), new ones if None."""
    mode, trees = _operands(api, shape, tc, operands)
    t0 = time.perf_counter()
    with mode, FlopCounterMode(display=False) as fc, Traffic() as tr:
        run_step(api, shape, tc, trees)
    return {"flops": float(fc.get_total_flops()),
            "op_bytes": float(tr.op_bytes), "temp_bytes": float(tr.peak),
            "seconds": time.perf_counter() - t0}


def place_cell(api, shape: ShapeConfig, mesh, trees: Dict[str, Any]
               ) -> Dict[str, Any]:
    """A cell's operands (whole, as :func:`launch.steps.shape_trees` or an
    init gives them) with the params, the optimizer state and the cache
    cut to this rank's blocks of ``mesh`` by ``api.cfg.sharding_profile``'s
    rules (``rules.place``); the inputs stay whole: the step cuts its
    batch block itself."""
    shards = S.cell_shardings(api, shape, mesh, trees,
                              api.cfg.sharding_profile)
    return dict(trees, **{k: rules.place(trees[k], shards[k])
                          for k in ("params", "opt", "cache") if k in trees})


def rank_step_cost(api, shape: ShapeConfig, tc: TrainConfig, mesh,
                   operands=None) -> Dict[str, Any]:
    """Rank 0's program of the cell's step on ``mesh``, a counting mesh
    (``launch.mesh.counting_mesh``), on fake tensors: the operands of
    :func:`launch.steps.shape_trees` cut to rank 0's blocks by
    ``api.cfg.sharding_profile``'s rules (the batch is cut by the step,
    as on a process-group mesh), then the step placed by the same
    profile.  Returns rank 0's FLOPs, op bytes and temp peak, the
    seconds the run took and ``log``, the collectives it issued
    (``sharding.collectives.record``).  ``operands`` as
    :func:`fake_step_cost`'s."""
    profile = api.cfg.sharding_profile
    mode, trees = _operands(api, shape, tc, operands)
    with mode, use_mesh(mesh):
        placed = place_cell(api, shape, mesh, trees)
        t0 = time.perf_counter()
        with FlopCounterMode(display=False) as fc, Traffic() as tr, \
                C.record() as log:
            run_step(api, shape, tc, placed, profile)
    return {"flops": float(fc.get_total_flops()),
            "op_bytes": float(tr.op_bytes), "temp_bytes": float(tr.peak),
            "seconds": time.perf_counter() - t0, "log": tuple(log)}


def slow_cell(cfg, shape: ShapeConfig) -> bool:
    """A cell whose fake step runs a Python loop over the sequence
    (xLSTM's sLSTM, to train or prefill)."""
    return cfg.family == "ssm" and shape.kind != "decode"


_TRAIN = TrainConfig(optimizer="adamw", lr=3e-4, lr_min=3e-5)


@functools.lru_cache(maxsize=None)
def _cell_operands(arch: str, shape_name: str, profile: str,
                   variant: Optional[str]):
    """A fake mode and ``launch.steps.shape_trees`` of a cell made in it,
    shared by both meshes and every count (fake tensors hold no values,
    so a step that writes into them leaves them as they were)."""
    cfg = _cell_config(arch, profile, variant)
    mode = S.fake_mode()
    return mode, S.shape_trees(get_model(cfg), LM_SHAPES[shape_name],
                               _TRAIN, mode)


@functools.lru_cache(maxsize=None)
def _cached_cell_cost(arch: str, shape_name: str, profile: str,
                      variant: Optional[str]) -> Tuple[Tuple[str, Any], ...]:
    """:func:`fake_step_cost` of a cell under the single-pod mesh, which
    the multi-pod mesh shares (module docstring)."""
    cfg = _cell_config(arch, profile, variant)
    with use_mesh(make_production_mesh()):
        cost = fake_step_cost(
            get_model(cfg), LM_SHAPES[shape_name], _TRAIN,
            _cell_operands(arch, shape_name, profile, variant))
    return tuple(cost.items())


@functools.lru_cache(maxsize=None)
def _cached_rank_cost(arch: str, shape_name: str, profile: str,
                      variant: Optional[str], mesh_kind: str
                      ) -> Tuple[Tuple[str, Any], ...]:
    """:func:`rank_step_cost` of a cell on the counting mesh of
    ``mesh_kind``."""
    cfg = _cell_config(arch, profile, variant)
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"),
                                counting=True)
    cost = rank_step_cost(get_model(cfg), LM_SHAPES[shape_name], _TRAIN,
                          mesh, _cell_operands(arch, shape_name, profile,
                                               variant))
    return tuple(cost.items())


def collective_summary(log) -> Dict[str, Any]:
    """A rank's collectives (``sharding.collectives.Collective``s) by
    op: calls, bytes, and the group sizes and dtypes they ran at."""
    out: Dict[str, Any] = {"calls": len(log), "calls_by_type": {},
                           "by_group": {}}
    for c in log:
        out["calls_by_type"][c.op] = out["calls_by_type"].get(c.op, 0) + 1
        key = f"{c.op} {c.dtype} x{c.group_size}"
        out["by_group"][key] = out["by_group"].get(key, 0) + c.bytes
    return out


def _cell_config(arch: str, profile: str, variant: Optional[str]):
    cfg = get_config(arch)
    if profile != "default":
        cfg = cfg.replace(sharding_profile=profile)
    if variant:
        cfg = apply_variant(cfg, variant)
    return cfg


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             profile: str = "default", out_dir: str = "artifacts/dryrun_torch",
             fast: bool = False, variant: str = None,
             slow: bool = False) -> dict:
    """One cell's record (also written as JSON).  Every divided term
    assumes an ideal partition over the mesh's devices.  A
    :func:`slow_cell` is counted only with ``slow``."""
    cfg = _cell_config(arch, profile, variant)
    key = (arch, shape_name, profile, variant)
    if variant:
        profile = variant
    shape = LM_SHAPES[shape_name]
    ok, why = cell_is_runnable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "profile": profile, "kind": shape.kind,
           "seq_len": shape.seq_len, "global_batch": shape.global_batch}
    out_path = pathlib.Path(out_dir) / mesh_kind / arch
    out_path.mkdir(parents=True, exist_ok=True)
    f = out_path / (shape_name +
                    ("" if profile == "default" else "." + profile) +
                    ".json")
    if not ok:
        rec.update(status="skipped", reason=why)
        f.write_text(json.dumps(rec, indent=1))
        return rec

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"))
    n_chips = mesh.size
    api = get_model(cfg)
    t0 = time.perf_counter()
    trees = _cell_operands(*key)[1]
    shards = S.cell_shardings(api, shape, mesh, trees, cfg.sharding_profile)
    arg_bytes = sum(rules.shard_bytes(trees[k], shards[k]) for k in shards)
    t_trees = time.perf_counter() - t0
    total, active, embed = _tree_param_counts(trees["params"], cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    model_flops = RL.model_flops_estimate(active - embed, tokens, shape.kind)
    rec.update(params_total=total, params_active=active, tokens=tokens,
               fake_device=S.FAKE_DEVICE)
    if fast:
        rec.update(status="ok", n_chips=n_chips, compile_s=round(t_trees, 2),
                   cost_method="fast(arguments only)",
                   memory={"argument_size_in_bytes": arg_bytes},
                   bytes_per_device=arg_bytes)
        f.write_text(json.dumps(rec, indent=1))
        return rec

    if slow_cell(cfg, shape) and not slow:
        rec.update(status="deferred", n_chips=n_chips,
                   memory={"argument_size_in_bytes": arg_bytes},
                   reason=("the sLSTM cell runs once a time step: minutes "
                           "to an hour of fake ops; pass --slow-cells"))
        f.write_text(json.dumps(rec, indent=1))
        return rec
    cost = dict(_cached_cell_cost(*key))
    temp = cost["temp_bytes"] / n_chips
    mem = {"argument_size_in_bytes": arg_bytes,
           "temp_size_in_bytes": int(temp), "alias_size_in_bytes": 0}
    flops, hbm = cost["flops"] / n_chips, cost["op_bytes"] / n_chips
    rank = dict(_cached_rank_cost(*key, mesh_kind))
    rl = RL.Roofline.from_log(flops, hbm, rank["log"], model_flops)
    rec.update(
        collectives=collective_summary(rank["log"]),
        collective_method=(
            "rank 0's step on the counting mesh, fake tensors cut to "
            "its blocks, every collective logged "
            "(sharding.collectives.record); ring model, NVLink "
            f"{rl.hw.link_bw / 1e9:g} GB/s sent within a node of "
            f"{rl.hw.node_size}, {rl.hw.net_bw / 1e9:g} GB/s across"),
        rank_cost={k: rank[k] for k in ("flops", "op_bytes",
                                        "temp_bytes", "seconds")})
    rec.update(
        status="ok", n_chips=n_chips, compile_s=round(cost["seconds"], 2),
        cost_method=("fake_eager: FlopCounterMode FLOPs and op bytes "
                     f"(device arguments and results of every allocating "
                     f"or writing aten op), global / n_chips (ideal "
                     f"partition)"),
        temp_method=("peak live device storage bytes the step allocates "
                     "above its arguments, each rounded up to "
                     f"{ALLOC_ROUND} bytes, global / n_chips (ideal "
                     "partition)"),
        memory=mem, bytes_per_device=int(arg_bytes + temp),
        global_cost={k: cost[k] for k in ("flops", "op_bytes",
                                          "temp_bytes")},
        roofline=rl.to_dict(),
        useful_flops_ratio=rl.useful_flops_ratio(n_chips),
        roofline_fraction=rl.roofline_fraction(n_chips),
    )
    f.write_text(json.dumps(rec, indent=1))
    return rec


def _fmt(x) -> str:
    return "—" if x is None else f"{x:.3e}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--profile", default="default")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--fast", action="store_true",
                    help="shardings and argument bytes only (no fake step)")
    ap.add_argument("--variant", default=None, choices=list(VARIANTS))
    ap.add_argument("--slow-cells", action="store_true",
                    help="also count xLSTM's train and prefill cells "
                         "(minutes to an hour each)")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(LM_SHAPES) if args.shape == "all" else [args.shape]
    meshes = (["pod", "multipod"] if args.mesh == "both" else [args.mesh])
    failures = 0
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                tag = f"[{mesh_kind}|{arch}|{shape}]"
                t0 = time.perf_counter()
                try:
                    rec = run_cell(arch, shape, mesh_kind, args.profile,
                                   args.out, fast=args.fast,
                                   variant=args.variant,
                                   slow=args.slow_cells)
                except Exception:   # noqa: BLE001 - reported, counted
                    failures += 1
                    print(f"{tag} FAILED\n{traceback.format_exc()}",
                          flush=True)
                    continue
                took = time.perf_counter() - t0
                if rec["status"] in ("skipped", "deferred"):
                    print(f"{tag} {rec['status'].upper()}: {rec['reason']}",
                          flush=True)
                elif "roofline" not in rec:
                    print(f"{tag} ok trees={rec['compile_s']:.1f}s "
                          f"bytes/dev={rec['bytes_per_device']/2**30:.2f}GiB "
                          f"(fast) cell={took:.2f}s", flush=True)
                else:
                    r = rec["roofline"]
                    print(f"{tag} ok step={rec['compile_s']:.1f}s "
                          f"bytes/dev={rec['bytes_per_device']/2**30:.2f}GiB "
                          f"t_comp={_fmt(r['t_compute'])} "
                          f"t_mem={_fmt(r['t_memory'])} "
                          f"t_coll={_fmt(r['t_collective'])} "
                          f"bound={r['bottleneck']} cell={took:.2f}s",
                          flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
