"""Op-level analysis of the port's stage callables: the twin of ``repro.analysis.trace``.

JAX traces a stage callable to a jaxpr on abstract inputs and walks it.
The port runs the callable once, on small real tensors made from a seed,
and records what it did:

* every aten op, through a ``TorchDispatchMode`` (as the dry-run's
  ``launch.dryrun.Traffic`` counts them): its name, the dtype and device
  of each tensor it reads and writes, and which earlier op made each
  tensor it reads.  That data-flow graph is the port's counterpart of a
  jaxpr's vars.  A tensor no recorded op made is an input (an argument
  or a parameter) or a constant;
* the host reads no aten op shows, ``Tensor.numpy``, ``Tensor.tolist``
  and ``Tensor.__array__``, through a ``TorchFunctionMode``;
* every kernel launch, through ``kernels._build.RECORDER``: the launch is
  named by its kernel between its prologue and epilogue, is opaque, and
  reads the recorded tensors whose memory its arguments point to;
* every collective, through ``sharding.collectives.record``, with the
  mesh axes of its group.

On CUDA tensors the kernels launch; on CPU tensors every kernel wrapper
runs its plain version (``repro_torch.kernels.ops``), so a CPU trace
checks the plain versions and a card trace the kernels' prologues and
epilogues.  Inputs are real tensors, not ``meta`` ones: the wrappers
refuse tensors without memory.  An op runs in a *sharded region* when
the trace says so (``in_shard_region``: the stage callables of a
``data_shards > 1`` spec) or when the current mesh
(``sharding.context.current_mesh``) splits a ``"data"`` axis over more
than one device, as ``serve.sharding.shard_forward`` installs it.

The contracts, by code:

RPA201  float64, port form.  A float64 value is legal only inside a
        *rounded-once island*: it is made inside the callable from
        values that are not float64, and every path from it reaches a
        convert to a dtype of 32 bits or fewer (or a kernel launch,
        which rounds into its own buffers) before any output or any
        other kind of value.  An f64 input, parameter, constant or
        output is RPA201, and so is an f64 value that leaves its island
        unrounded (an f64 value returned, read to the host, or compared
        into a mask).  The port's islands:
        ``kernels/ref.py::int8_matmul_ref`` forms the int32 accumulator
        in float64 (exact: every partial sum is an integer below 2**53);
        ``core/knn.py::group_sigma`` sums the squared offsets and takes
        the root in float64, each rounded once to float32, so the card
        and the CPU agree bit for bit; and
        ``kernels/grouped_transfer.py``'s stats launch writes its
        fixed-order partial sums to a float64 buffer only the kernel
        reads.
RPA202  a silent int8->float upcast: JAX's taint walk.  An int8 or
        uint8 value converted to a float type is tainted; the dequant
        ``mul`` by the scale sanctions it, the ops that move a value
        without arithmetic (views, copies, converts) pass the taint on,
        and any other consumer is RPA202.  The port adds one sanctioned
        consumer, the *exact integer accumulate*: a matmul (``mm``,
        ``addmm``, ``bmm``, ``matmul``) whose floating operands are all
        tainted, each used by that matmul alone, and whose result
        reaches only converts to an integer dtype (through views) before
        any other use.  ``kernels/ref.py::int8_matmul_ref`` is that
        pattern: ``(x_q.double() @ w_q.double()).to(torch.int32)``.
        The same convert feeding a matmul whose float result is kept is
        RPA202.
RPA203  a host read or live RNG inside a sharded region: the reads of
        :data:`HOST_CALLBACK_PRIMITIVES` and a copy between the host and
        a card (on the card), and the draws of
        :data:`NONDETERMINISTIC_PRIMITIVES`.  The framework's randomness
        is the explicit LFSR state.  A copy between two cards is the
        split's own placement (JAX places its ``shard_map`` inputs
        outside the body) and is not flagged.  The finding names each
        read's caller (file:line) and count.
RPA204  a collective over the ``"data"`` mesh axis, read from
        ``sharding.collectives.record``'s log: lanes are independent,
        which is what makes ``data_shards`` bit-invisible.  A collective
        issued outside ``sharding.collectives`` is not seen.
RPA209  a callable that raises while traced.

Entry points: :func:`scan_ops` (one recorded :class:`OpTrace`, the twin
of ``scan_jaxpr``), :func:`trace_callable` (trace + scan),
:func:`analyze_plan_trace` (every distinct CBR / fused op of a lowered
spec), :func:`analyze_sharded_callable` (a whole dispatch).  Each takes
an optional ``traces`` list that gets every :class:`OpTrace` made.
"""
from __future__ import annotations

import collections
import dataclasses
import pathlib
import sys
import threading
import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.findings import Finding, dedupe, finding
from repro_torch.kernels import _build
from repro_torch.sharding import collectives, context

#: Ops that read a tensor to the host: forbidden inside a sharded
#: region (RPA203).  The ``Tensor.*`` names are seen by the function
#: mode, the ``aten::*`` ones by the dispatch mode.
HOST_CALLBACK_PRIMITIVES = frozenset({
    "aten::_local_scalar_dense", "aten::item", "aten::nonzero",
    "Tensor.numpy", "Tensor.tolist", "Tensor.__array__",
})

#: Live-RNG ops: nondeterministic against the framework's explicit-LFSR
#: contract when they appear inside a sharded region (RPA203).
NONDETERMINISTIC_PRIMITIVES = frozenset({
    "aten::rand", "aten::rand_like", "aten::randn", "aten::randn_like",
    "aten::randint", "aten::randint_like", "aten::randperm",
    "aten::normal", "aten::normal_", "aten::uniform_", "aten::bernoulli",
    "aten::bernoulli_", "aten::multinomial", "aten::exponential_",
    "aten::random_", "aten::native_dropout",
})

#: Collectives, by ``sharding.collectives.Collective.op``; flagged
#: (RPA204) when their group spans the ``"data"`` mesh axis.
COLLECTIVE_PRIMITIVES = frozenset({"all-reduce", "all-gather",
                                   "all-to-all"})

# Converts: their source is their first tensor (copy_'s second).  The
# composite names (to, type_as, matmul, reshape, ...) reach the mode for
# tensors outside autograd (inference mode).
_CONVERTS = frozenset({"aten::_to_copy", "aten::to", "aten::type_as",
                       "aten::copy_"})
#: Ops that move a tainted (silently upcast) value around without
#: consuming it arithmetically: the taint flows through.
_TAINT_PASSTHROUGH = _CONVERTS | frozenset({
    "aten::view", "aten::_unsafe_view", "aten::view_as", "aten::reshape",
    "aten::reshape_as", "aten::flatten", "aten::unflatten", "aten::expand",
    "aten::expand_as", "aten::permute", "aten::movedim", "aten::transpose",
    "aten::t", "aten::squeeze", "aten::unsqueeze", "aten::clone",
    "aten::contiguous", "aten::alias", "aten::detach", "aten::slice",
    "aten::select", "aten::narrow", "aten::flip", "aten::as_strided",
    "aten::resolve_conj", "aten::resolve_neg",
})
_MATMULS = frozenset({"aten::mm", "aten::addmm", "aten::bmm",
                      "aten::matmul"})
_DEQUANT = frozenset({"aten::mul", "aten::mul_"})
_INT_NARROW = (torch.int8, torch.uint8)
# ops whose tensor argument is made inside the callable (torch.tensor)
_MADE_HERE = frozenset({"aten::lift_fresh", "aten::lift_fresh_copy"})
_HOST_FUNCS = {torch.Tensor.numpy: "Tensor.numpy",
               torch.Tensor.tolist: "Tensor.tolist",
               torch.Tensor.__array__: "Tensor.__array__"}
_LAUNCH = "launch:"
_TORCH_DIR = str(pathlib.Path(torch.__file__).resolve().parent)
_SRC_DIR = pathlib.Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class Value:
    """One tensor value: its dtype and device, the index of the op that
    made it (None: made outside the callable) and whether it is an
    argument (else, when made outside, a constant)."""
    dtype: torch.dtype
    device: torch.device
    producer: Optional[int]
    arg: bool = False


@dataclasses.dataclass
class Op:
    """One recorded op: its name (``aten::mm``, ``Tensor.numpy``,
    ``launch:int8_matmul``), the values it reads and makes, whether it
    ran in a sharded region and, for a host read, a copy between the
    host and a card or a draw, its caller as ``file:line``."""
    name: str
    ins: Tuple[int, ...]
    outs: Tuple[int, ...]
    sharded: bool
    site: str = ""


@dataclasses.dataclass
class OpTrace:
    """What one callable did: the op stream over its values, the values
    it returned, the collectives it issued, its kernel launches by
    kernel, and, once scanned, its float64 islands accepted."""
    where: str
    ops: List[Op]
    values: List[Value]
    outputs: Tuple[int, ...]
    collectives: List[Any]
    launches: collections.Counter
    islands: int = 0

    @property
    def n_aten(self) -> int:
        """aten ops recorded."""
        return sum(op.name.startswith("aten::") for op in self.ops)


def _site() -> str:
    """The innermost caller outside torch and this module, as
    ``file:line`` (relative to ``src`` where it lies there)."""
    frame = sys._getframe(1)
    here = __file__
    while frame is not None:
        path = frame.f_code.co_filename
        if path != here and not path.startswith(_TORCH_DIR):
            p = pathlib.Path(path)
            try:
                p = p.relative_to(_SRC_DIR)
            except ValueError:
                p = pathlib.Path(p.name)
            return f"{p}:{frame.f_lineno}"
        frame = frame.f_back
    return "?"


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _source(op: Op) -> int:
    """A convert's source value."""
    return op.ins[1] if op.name == "aten::copy_" else op.ins[0]


def _is_host_copy(devices) -> bool:
    kinds = {d.type for d in devices}
    return "cpu" in kinds and len(kinds) > 1


class _Recorder:
    """The data-flow graph of one traced call (module docstring)."""

    def __init__(self, in_shard_region: bool):
        self.in_shard_region = in_shard_region
        self.values: List[Value] = []
        self.ops: List[Op] = []
        self.launches: collections.Counter = collections.Counter()
        # id(tensor) -> its current value; every tensor seen stays alive
        # for the trace, so no id is reused
        self._of: Dict[int, int] = {}
        self._alive: Dict[int, torch.Tensor] = {}
        self._thread = threading.get_ident()

    def value(self, t: torch.Tensor, producer: Optional[int] = None,
              arg: bool = False) -> int:
        self.values.append(Value(t.dtype, t.device, producer, arg))
        self._of[id(t)] = len(self.values) - 1
        self._alive[id(t)] = t
        return len(self.values) - 1

    def read(self, t: torch.Tensor) -> int:
        v = self._of.get(id(t))
        return self.value(t) if v is None else v

    def sharded(self) -> bool:
        if self.in_shard_region:
            return True
        mesh = context.current_mesh()
        return mesh is not None and mesh.shape.get("data", 1) > 1

    def note(self, name: str, ins, outs, site: str = "") -> None:
        reads = tuple(self.read(t) for t in ins)
        at = len(self.ops)
        made = tuple(self.value(t, at) for t in outs)
        self.ops.append(Op(name, reads, made, self.sharded(), site))

    def launch(self, name: str, device, args) -> None:
        """``_build.RECORDER``: the launch reads every recorded tensor
        whose memory one of its pointer arguments names."""
        if threading.get_ident() != self._thread:
            return
        ptrs = {a for a in args if isinstance(a, int) and a}
        ins = [t for t in self._alive.values()
               if t.device.type != "meta" and t.data_ptr() in ptrs]
        self.launches[name] += 1
        self.note(_LAUNCH + name, ins, ())


class _AtenMode(TorchDispatchMode):
    def __init__(self, rec: _Recorder):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.name().split(".")[0]
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        site = ""
        if (name in HOST_CALLBACK_PRIMITIVES
                or name in NONDETERMINISTIC_PRIMITIVES
                or (name in _CONVERTS
                    and _is_host_copy(t.device for t in ins + outs))):
            site = _site()
        self.rec.note(name, () if name in _MADE_HERE else ins, outs, site)
        return out


class _HostReadMode(TorchFunctionMode):
    def __init__(self, rec: _Recorder):
        super().__init__()
        self.rec = rec

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = _HOST_FUNCS.get(func)
        if name is not None:
            self.rec.note(name, _tensors(args), (), _site())
        return func(*args, **(kwargs or {}))


# ------------------------------------------------------------ scanning --

def _consumers(tr: OpTrace) -> List[List[int]]:
    out: List[List[int]] = [[] for _ in tr.values]
    for i, op in enumerate(tr.ops):
        for v in op.ins:
            out[v].append(i)
    return out


def _f64(tr: OpTrace, v: int) -> bool:
    return tr.values[v].dtype == torch.float64


def _is_int(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex
                or dtype == torch.bool)


def _scan_f64(tr: OpTrace, where: str, out: List[Finding]) -> None:
    """RPA201, port form: every f64 value lies in a rounded-once island;
    ``tr.islands`` gets the islands (connected f64 values) accepted."""
    parent = list(range(len(tr.values)))

    def root(v: int) -> int:
        while parent[v] != v:
            parent[v] = parent[parent[v]]
            v = parent[v]
        return v

    bad = set()
    for v, val in enumerate(tr.values):
        if val.dtype == torch.float64 and val.producer is None:
            bad.add(v)
            out.append(finding(
                "RPA201", where,
                f"float64 {'input' if val.arg else 'constant'} (value {v}): "
                f"the deployment arithmetic is fp32/int8; a float64 value "
                f"may only be made inside the callable and rounded once"))
    for i, op in enumerate(tr.ops):
        wide = [v for v in op.ins + op.outs if _f64(tr, v)]
        for v in wide[1:]:
            parent[root(v)] = root(wide[0])
        if not any(_f64(tr, v) for v in op.ins):
            continue
        if op.name.startswith(_LAUNCH):
            continue            # the kernel rounds into its own buffers
        if op.outs and all(_f64(tr, v) for v in op.outs):
            continue            # still inside the island
        if (op.name in _CONVERTS and op.outs
                and all(tr.values[v].dtype.itemsize <= 4 for v in op.outs)):
            continue            # rounded once: the island ends here
        bad.update(v for v in op.ins if _f64(tr, v))
        out.append(finding(
            "RPA201", where,
            f"a float64 value leaves its island through {op.name!r} "
            f"(op {i}) without a convert to 32 bits or fewer"))
    for v in tr.outputs:
        if _f64(tr, v):
            bad.add(v)
            out.append(finding(
                "RPA201", where,
                f"float64 output (value {v}): every float64 value must be "
                f"rounded to 32 bits or fewer before it leaves the "
                f"callable"))
    islands = {root(v) for v in range(len(tr.values)) if _f64(tr, v)}
    tr.islands = len(islands - {root(v) for v in bad})


def _exact_accumulate(tr: OpTrace, op: Op, tainted: Dict[int, tuple],
                      consumers: List[List[int]]) -> bool:
    """Whether ``op`` (a matmul reading a tainted value) is the exact
    integer accumulate of the module docstring."""
    floats = [v for v in op.ins if tr.values[v].dtype.is_floating_point]
    if any(v not in tainted for v in floats):
        return False
    outputs = set(tr.outputs)
    for v in floats:
        if any(len(set(consumers[link])) != 1 or link in outputs
               for link in tainted[v]):
            return False
    todo, converted = list(op.outs), False
    while todo:
        r = todo.pop()
        if r in outputs:
            return False
        for c in consumers[r]:
            nxt = tr.ops[c]
            if (nxt.name in _CONVERTS and _source(nxt) == r
                    and all(_is_int(tr.values[o].dtype) for o in nxt.outs)):
                converted = True
            elif (nxt.name in _TAINT_PASSTHROUGH
                    and nxt.name not in _CONVERTS):
                todo.extend(nxt.outs)
            else:
                return False
    return converted


def _scan_taint(tr: OpTrace, where: str, out: List[Finding]) -> None:
    """RPA202: JAX's int8->float taint walk with the exact integer
    accumulate sanctioned."""
    consumers = _consumers(tr)
    # tainted value -> the values from its seed convert's result to it
    tainted: Dict[int, tuple] = {}
    for i, op in enumerate(tr.ops):
        if op.name in _CONVERTS and op.ins and op.outs:
            src, dst = _source(op), op.outs[0]
            if (tr.values[src].dtype in _INT_NARROW
                    and tr.values[dst].dtype.is_floating_point):
                tainted[dst] = (dst,)
                continue
        hot = [v for v in op.ins if v in tainted]
        if not hot or op.name in _DEQUANT:
            continue            # the dequant idiom sanctions the upcast
        if op.name in _TAINT_PASSTHROUGH:
            for o in op.outs:
                tainted[o] = tainted[hot[0]] + (o,)
            continue
        if op.name in _MATMULS and _exact_accumulate(tr, op, tainted,
                                                     consumers):
            continue
        out.append(finding(
            "RPA202", where,
            f"int8->float converted value reaches {op.name!r} (op {i}) "
            f"without the dequant scale multiply: the raw quantized "
            f"integers are being used as float weights"))


def _counted(ops: List[Op]) -> str:
    seen = collections.Counter((op.name, op.site) for op in ops)
    return ", ".join(f"{name} at {site} x{n}"
                     for (name, site), n in seen.items())


def _scan_region(tr: OpTrace, where: str, out: List[Finding]) -> None:
    """RPA203 (host reads, host<->card copies and draws inside a sharded
    region) and RPA204 (collectives over ``"data"``)."""
    reads, draws = [], []
    for op in tr.ops:
        if not op.sharded:
            continue
        if op.name in HOST_CALLBACK_PRIMITIVES or (
                op.name in _CONVERTS and _is_host_copy(
                    tr.values[v].device for v in op.ins + op.outs)):
            reads.append(op)
        elif op.name in NONDETERMINISTIC_PRIMITIVES:
            draws.append(op)
    if reads:
        out.append(finding(
            "RPA203", where,
            f"host reads inside a sharded region ({_counted(reads)}): "
            f"each syncs the device and breaks lane-mapped determinism"))
    if draws:
        out.append(finding(
            "RPA203", where,
            f"live RNG inside a sharded region ({_counted(draws)}): the "
            f"framework's randomness contract is the explicit LFSR state"))
    for c in tr.collectives:
        if c.op in COLLECTIVE_PRIMITIVES and "data" in c.axes:
            out.append(finding(
                "RPA204", where,
                f"collective {c.op!r} over mesh axes {c.axes} couples "
                f"lanes across the 'data' split: sharding would no longer "
                f"be bit-invisible"))


def scan_ops(tr: OpTrace, where: Optional[str] = None) -> List[Finding]:
    """All findings of one recorded call, deduped by (code, site); sets
    ``tr.islands``."""
    where = tr.where if where is None else where
    out: List[Finding] = []
    _scan_f64(tr, where, out)
    _scan_taint(tr, where, out)
    _scan_region(tr, where, out)
    return dedupe(out)


def _record(fn, args, where: str, in_shard_region: bool) -> OpTrace:
    """Run ``fn(*args)`` under the recorder; raises what ``fn``
    raises."""
    rec = _Recorder(in_shard_region)
    for t in _tensors(args):
        if id(t) not in rec._of:
            rec.value(t, arg=True)
    prev = _build.RECORDER
    _build.RECORDER = rec.launch
    try:
        with collectives.record() as log, _HostReadMode(rec), \
                _AtenMode(rec):
            result = fn(*args)
    finally:
        _build.RECORDER = prev
    outputs = tuple(rec.read(t) for t in _tensors(result))
    return OpTrace(where, rec.ops, rec.values, outputs, list(log),
                   rec.launches)


def trace_callable(fn, *args, where: str = "<callable>",
                   in_shard_region: bool = False,
                   traces: Optional[list] = None) -> List[Finding]:
    """Run ``fn`` on ``args`` (real tensors) under the recorder and scan
    it; a callable that raises is itself a finding (RPA209).  ``traces``
    gets the :class:`OpTrace`."""
    try:
        tr = _record(fn, args, where, in_shard_region)
    except Exception as e:  # noqa: BLE001 — any trace failure is the finding
        return [finding("RPA209", where,
                        f"failed to trace: {type(e).__name__}: {e}")]
    found = scan_ops(tr, where)
    if traces is not None:
        traces.append(tr)
    return found


# --------------------------------------------- plan-wide tracing --------

class _Inputs:
    """Small real tensors made from one seed on one device: the port's
    counterpart of JAX's ``ShapeDtypeStruct`` inputs."""

    def __init__(self, device, seed: int = 0):
        self.device = torch.device(device)
        self.gen = torch.Generator().manual_seed(seed)

    def __call__(self, shape, dtype=torch.float32) -> torch.Tensor:
        if dtype == torch.int8:
            t = torch.randint(-127, 128, tuple(shape), generator=self.gen,
                              dtype=torch.int8)
        else:
            t = torch.randn(tuple(shape), generator=self.gen).to(dtype)
        return t.to(self.device)

    def scale(self, shape) -> torch.Tensor:
        return (torch.rand(tuple(shape), generator=self.gen) * 0.01
                + 1e-3).to(self.device)

    def indices(self, n: int, s: int) -> torch.Tensor:
        return torch.randperm(n, generator=self.gen)[:s][None].to(
            self.device)


def _cbr_params(make: _Inputs, c_in: int, c_out: int,
                int8_export: bool) -> Dict:
    """A frozen layer's params (``api.build``'s export: fused (w, b), an
    int8 stage's w as a ``{"q", "scale"}`` dict)."""
    if int8_export:
        w = {"q": make((c_in, c_out), torch.int8),
             "scale": make.scale((1, c_out))}
    else:
        w = make((c_in, c_out))
    return {"w": w, "b": make((c_out,))}


def _cbr_shape_walk(plan, cfg) -> List[Tuple[Any, int, int]]:
    """(op, c_in, c_out) for every CBR of the plan, by the topology walk
    ``cost_breakdown`` uses."""
    from repro_torch.api import plan as plan_mod
    out: List[Tuple[Any, int, int]] = []
    c_prev = cfg.embed_dim
    for op in plan.ops:
        if isinstance(op, plan_mod.EmbedOp):
            out.append((op.cbr, 3, cfg.embed_dim))
        elif isinstance(op, plan_mod.FusedGroupTransferOp):
            c = cfg.stage_dims[op.stage]
            out.append((op.cbr, 2 * c_prev, c))
            c_prev = c
        elif isinstance(op, plan_mod.CBROp):          # stage transfer
            c = cfg.stage_dims[op.stage]
            out.append((op, 2 * c_prev, c))
            c_prev = c
        elif isinstance(op, plan_mod.ResBlockOp):
            c = cfg.stage_dims[op.stage]
            mid = max(1, int(c * cfg.res_expansion))
            out.append((op.net1, c, mid))
            out.append((op.net2, mid, c))
        elif isinstance(op, (plan_mod.HeadOp, plan_mod.SegHeadOp)):
            c_head = (cfg.embed_dim + 2 * c_prev
                      if isinstance(op, plan_mod.SegHeadOp) else c_prev)
            out.append((op.fc1, c_head, 512))
            out.append((op.fc2, 512, 256))
    return out


def analyze_plan_trace(spec, cfg=None, plan=None, device="cpu",
                       traces: Optional[list] = None) -> List[Finding]:
    """Trace every *distinct* resolved CBR callable of a lowered spec
    (and each fused group->transfer op) and scan the op streams.
    Distinctness is (c_in, c_out, precision, backend, act, exported): a
    plan traces a handful of callables, not hundreds.

    The inputs are made from seed 0 on ``device``: the CPU (the CLI's
    gate; the kernel wrappers run their plain versions) or a card
    (``"cuda"``: the kernels launch, and ``traces`` shows them).  A CBR
    callable runs on ``(4, c_in)`` rows, a fused op on its stage's real
    shapes at batch 1.  The spec must pass the ``lowering`` analysis
    scope (this function lowers it); ``data_shards > 1`` scans every
    callable as a sharded region (RPA203 armed).
    """
    from repro_torch.api import plan as plan_mod
    if cfg is None:
        cfg = spec.to_model_config()
    if plan is None:
        with warnings.catch_warnings():
            # the lowering scope reports its own warnings
            warnings.simplefilter("ignore")
            plan = plan_mod.lower(spec, cfg)
    in_shard = spec.data_shards > 1
    make = _Inputs(device)
    out: List[Finding] = []
    seen: set = set()
    for cbr, c_in, c_out in _cbr_shape_walk(plan, cfg):
        exported = cbr.precision == "int8"
        key = (c_in, c_out, cbr.precision, cbr.backend, cbr.act, exported)
        if key in seen or cbr.fn is None:
            continue
        seen.add(key)
        where = ".".join(str(p) for p in cbr.path)
        out += trace_callable(
            lambda p, x, _fn=cbr.fn, _q=cbr.quant, _a=cbr.act:
                _fn(p, x, _q, _a),
            _cbr_params(make, c_in, c_out, exported), make((4, c_in)),
            where=f"{where}[{cbr.precision}/{cbr.backend}]",
            in_shard_region=in_shard, traces=traces)
    out += _trace_fused_ops(plan, cfg, in_shard, make, traces)
    return dedupe(out)


def _trace_fused_ops(plan, cfg, in_shard: bool, make: _Inputs,
                     traces: Optional[list]) -> List[Finding]:
    """Trace each fused group->transfer op on its stage's real shapes
    (the kernels have tile expectations that made-up sizes could miss)."""
    from repro_torch.api import plan as plan_mod
    out: List[Finding] = []
    for op in plan.ops:
        if not isinstance(op, plan_mod.FusedGroupTransferOp):
            continue
        s = op.stage
        n_in = cfg.n_points if s == 0 else cfg.stage_samples[s - 1]
        c_in = cfg.embed_dim if s == 0 else cfg.stage_dims[s - 1]
        c = cfg.stage_dims[s]
        args = [{"w": make((2 * c_in, c)), "b": make((c,))},
                make((1, n_in, 3)), make((1, n_in, c_in)),
                make.indices(n_in, cfg.stage_samples[s])]
        if cfg.affine_mode == "affine":
            args.append({"alpha": make((c_in,)), "beta": make((c_in,))})

        def fused(p, xyz, feats, idx, aff=None, _op=op):
            return _op.fn(p, xyz, feats, idx, _op.k, aff, cfg.affine_mode,
                          True, act=True)

        out += trace_callable(
            fused, *args, where=f"stages.{s}.fused[{op.kernel}]",
            in_shard_region=in_shard, traces=traces)
    return out


def analyze_sharded_callable(fn, *args, where: str = "<dispatch>",
                             traces: Optional[list] = None
                             ) -> List[Finding]:
    """Scan a whole dispatch callable (e.g. ``serve.sharding.
    shard_forward``'s) on real args: the deep check of a built
    pipeline's forward.  Sharded regions are read from the mesh the
    dispatch installs (``sharding.context.use_mesh``)."""
    return trace_callable(fn, *args, where=where, in_shard_region=False,
                          traces=traces)
