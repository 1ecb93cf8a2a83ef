"""Stage-plan IR: compile a PipelineSpec into an explicit per-stage op plan.

The twin of ``repro.api.plan`` for the ported ops (``EmbedOp``,
``SampleOp``, ``GroupOp``, ``FusedGroupTransferOp``, ``CBROp``,
``ResBlockOp``, ``PoolOp``, ``HeadOp``, ``SegHeadOp``).  ``lower(spec, cfg)`` resolves
every CBR op's precision and backend (``stage_precision`` /
``stage_backend`` mixes included) into a bound backend callable and
deployment :class:`QuantConfig`; with ``spec.fused_group`` set, each
stage's ``GroupOp`` + transfer ``CBROp`` pair becomes one
``FusedGroupTransferOp``; with ``spec.head="seg"`` a ``SegHeadOp`` takes
the place of the global pool and ``HeadOp``; with ``spec.stream`` every
mapping op is marked ``cached`` so a stream cache can replay it.  The
model walk (``repro_torch.models.pointmlp._forward_impl``) interprets
the plan.  :meth:`StagePlan.cost_breakdown` gives the analytic per-op
FLOPs and bytes the roofline estimate (``repro_torch.roofline``) and the
analyzer's perf pass read; :func:`lower_config` is the uniform plan of a
bare model config (``pointmlp_apply``'s route).  :func:`spec_fingerprint` and
:func:`spec_label` name a spec; :func:`enumerate_plan_space` is the
tuner's search space, pruned by the analyzer's lowering passes.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import itertools
import json
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from repro_torch.api import registry
from repro_torch.api.spec import N_STAGES as _N_STAGES
from repro_torch.api.spec import check_lowering
from repro_torch.core.quant import QuantConfig, is_quantizable_leaf_path
from repro_torch.kernels import tuning as kernel_tiles
from repro_torch.kernels.tuning import DEFAULT_TUNING, KernelTuning

_KERNEL_BACKENDS = ("cuda",)


# ------------------------------------------------------------- op IR ----

@dataclasses.dataclass(frozen=True)
class CBROp:
    """One Conv(+folded BN)(+ReLU) layer, fully resolved: ``path`` into
    the param tree, the backend callable ``fn`` and the ``quant`` it is
    handed (None = fp32)."""
    path: Tuple[Any, ...]
    stage: Optional[int]            # owning stage, None for embed/head
    act: bool
    precision: str
    backend: str
    quant: Optional[QuantConfig] = dataclasses.field(compare=False,
                                                     default=None)
    fn: Optional[Callable] = dataclasses.field(repr=False, compare=False,
                                               default=None)


@dataclasses.dataclass(frozen=True)
class EmbedOp:
    """Pointwise embedding conv: xyz [B,N,3] -> features [B,N,E]."""
    cbr: CBROp


@dataclasses.dataclass(frozen=True)
class SampleOp:
    """Pick stage centroids with the resolved sampler.

    ``cached`` (stream lowering): the walk replays the stage's indices
    from a stream cache, but only for a sampler with ``advances_state``
    False; a state-advancing sampler (URS) still runs, so the LFSR state
    walks as on the cold path.  The collect pass records the indices
    either way.  ``tile`` is the FPS register tile the spec pins (None:
    the kernel's own rule, or a sampler that launches no FPS).
    """
    stage: int
    n_samples: int
    cached: bool = False
    tile: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class GroupOp:
    """(xyz, feats, idx) -> (new_xyz, centre feats, grouped [B,S,k,2C]).

    ``cached`` (stream lowering) splits the grouper into its mapping half
    (``neighbor_index``, replayed from the stream cache) and its
    arithmetic half (``group_with_idx``, always recomputed).  ``tile`` is
    the kNN query tile the spec pins (None: the kernel's own rule, or a
    grouper that launches no kNN).
    """
    stage: int
    k: int
    cached: bool = False
    tile: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class FusedGroupTransferOp:
    """A ``GroupOp`` + transfer ``CBROp`` pair lowered to one fused
    gather + geometric-affine-normalize + matmul+bias+ReLU step
    (``repro_torch.api.registry.FUSED_OPS[kernel]``); the grouped
    ``[B, S, k, 2C]`` tensor never leaves the kernel.  ``fn`` carries the
    pinned ``tile_s`` (grouped_transfer) and ``knn_tile`` keywords."""
    stage: int
    k: int
    cbr: CBROp                      # the transfer layer it absorbs
    kernel: str                     # FUSED_OPS registry key
    fn: Optional[Callable] = dataclasses.field(repr=False, compare=False,
                                               default=None)


@dataclasses.dataclass(frozen=True)
class ResBlockOp:
    """Bottleneck residual block: relu(net2(net1(x)) + x)."""
    stage: int
    branch: str                     # "pre" ([B,S,k,C]) | "pos" ([B,S,C])
    index: int
    net1: CBROp
    net2: CBROp                     # act=False; the ReLU runs post-add


@dataclasses.dataclass(frozen=True)
class PoolOp:
    """Max-pool: axis=2 over neighbours, axis=1 the global pool."""
    stage: Optional[int]
    axis: int


@dataclasses.dataclass(frozen=True)
class HeadOp:
    """3-layer MLP classifier; fc3 is a linear without activation, run
    on the head's backend (``fc1.fn`` with act=False)."""
    fc1: CBROp
    fc2: CBROp
    fc3_path: Tuple[Any, ...]
    fc3_quant: Optional[QuantConfig] = dataclasses.field(compare=False,
                                                         default=None)


@dataclasses.dataclass(frozen=True)
class SegHeadOp:
    """Per-point segmentation head (``spec.head="seg"``): in place of the
    global ``PoolOp`` + :class:`HeadOp`, it max-pools the global
    descriptor itself, upsamples the last stage's features to the input
    points by 1-NN (the kNN kernel at k = 1), concatenates ``[embed,
    upsampled, global]`` and runs the 3-layer classifier per point ->
    ``[B, n_points, n_classes]``.  ``cached`` (stream lowering) replays
    the upsample index from a stream cache; ``knn_tile`` is the
    upsample's pinned kNN query tile."""
    fc1: CBROp
    fc2: CBROp
    fc3_path: Tuple[Any, ...]
    fc3_quant: Optional[QuantConfig] = dataclasses.field(compare=False,
                                                         default=None)
    cached: bool = False
    knn_tile: Optional[int] = None


# ---------------------------------------------------------- StagePlan ---

@dataclasses.dataclass(frozen=True)
class StagePlan:
    """A compiled op plan with its resolved per-stage policy."""
    name: str
    ops: Tuple[Any, ...]
    stage_precision: Tuple[str, ...]
    stage_backend: Tuple[str, ...]
    precision: str                  # embed + head precision
    backend: str                    # embed + head backend key
    fused_group: str = "none"       # FUSED_OPS key, or "none"
    head: str = "cls"               # "cls" | "seg" (SegHeadOp lowering)
    stream: bool = False            # cache-aware mapping ops
    #: ``spec.kernel_tuning`` or the defaults; the roofline estimate's
    #: tile-waste term reads it.
    tuning: KernelTuning = DEFAULT_TUNING

    def cbr_ops(self) -> List[CBROp]:
        """Every CBR layer in execution order (fused transfers included)."""
        out: List[CBROp] = []
        for op in self.ops:
            if isinstance(op, (EmbedOp, FusedGroupTransferOp)):
                out.append(op.cbr)
            elif isinstance(op, CBROp):
                out.append(op)
            elif isinstance(op, ResBlockOp):
                out.extend((op.net1, op.net2))
            elif isinstance(op, (HeadOp, SegHeadOp)):
                out.extend((op.fc1, op.fc2))
        return out

    @property
    def any_int8(self) -> bool:
        return "int8" in self.stage_precision or self.precision == "int8"

    def quant_predicate(self) -> Callable[[tuple, Any], bool]:
        """Select exactly the weight leaves whose region (stage, or
        embed/head) resolved to int8, for ``quantize_tree``."""
        def pred(path: tuple, leaf: Any) -> bool:
            if not (is_quantizable_leaf_path(path)
                    and getattr(leaf, "ndim", 0) >= 2):
                return False
            s = _path_stage(path)
            prec = self.precision if s is None else self.stage_precision[s]
            return prec == "int8"
        return pred

    def describe(self) -> str:
        fused = {op.stage for op in self.ops
                 if isinstance(op, FusedGroupTransferOp)}
        rows = []
        for s in range(_N_STAGES):
            row = (f"stage {s + 1}: {self.stage_precision[s]}/"
                   f"{self.stage_backend[s]}")
            if s in fused:
                row += f" [group->transfer fused: {self.fused_group}]"
            if self.stream:
                row += " [stream-cached mapping]"
            rows.append(row)
        rows.append(f"head: {self.head}/{self.precision}/{self.backend}")
        pinned = [f"{k} {kernel_tiles.pinned(k, self.tuning)}"
                  for k in kernel_tiles.KERNELS
                  if kernel_tiles.pinned(k, self.tuning) is not None]
        if pinned:
            rows.append(f"tiles: {', '.join(pinned)}")
        return "; ".join(rows)

    def cost_breakdown(self, cfg) -> List[Dict[str, Any]]:
        """Analytic per-op FLOPs, weight bytes and activation bytes, the
        rows of ``repro.api.plan.StagePlan.cost_breakdown``.

        The FLOPs are :func:`repro_torch.models.pointmlp.
        pointmlp_flops_breakdown`'s (the rows sum to ``pointmlp_flops``);
        the bytes follow the plan: an int8 region's weights are one byte
        and an f32 scale a column, and a fused group->transfer stage
        never writes the ``[S, k, 2C]`` grouped tensor, though its sigma
        stats pass still reads a ``[S, k, C]`` gather (all affine modes
        but "center").  No kNN or FPS work is counted, as in JAX.
        """
        from repro_torch.models.pointmlp import pointmlp_flops_breakdown
        flops = pointmlp_flops_breakdown(cfg)
        rows: List[Dict[str, Any]] = []

        def wbytes(c_in: int, c_out: int, precision: str) -> int:
            if precision == "int8":
                return c_in * c_out + 4 * c_out      # int8 q + f32 scales
            return 4 * c_in * c_out

        def row(op: str, w_bytes: int, act_bytes: int) -> None:
            rows.append({"op": op, "flops": flops[op],
                         "w_bytes": w_bytes, "act_bytes": act_bytes})

        n, e = cfg.n_points, cfg.embed_dim
        row("embed", wbytes(3, e, self.precision), 4 * n * e)
        c_prev = e
        fused = {op.stage for op in self.ops
                 if isinstance(op, FusedGroupTransferOp)}
        for s in range(_N_STAGES):
            smp, c = cfg.stage_samples[s], cfg.stage_dims[s]
            k = cfg.k_neighbors
            prec = self.stage_precision[s]
            if s not in fused:
                group_bytes = 4 * smp * k * 2 * c_prev
            elif cfg.affine_mode == "center":
                group_bytes = 0
            else:
                group_bytes = 4 * smp * k * c_prev
            row(f"stage{s + 1}.group", 0, group_bytes)
            row(f"stage{s + 1}.transfer", wbytes(2 * c_prev, c, prec),
                4 * smp * k * c)
            mid = max(1, int(c * cfg.res_expansion))
            blk = wbytes(c, mid, prec) + wbytes(mid, c, prec)
            row(f"stage{s + 1}.pre", cfg.pre_blocks[s] * blk,
                4 * smp * k * c)
            row(f"stage{s + 1}.pos", cfg.pos_blocks[s] * blk, 4 * smp * c)
            c_prev = c
        # The seg head runs per point on the [N, E + 2*C4] skip concat.
        c_in, m = ((cfg.embed_dim + 2 * c_prev, n) if self.head == "seg"
                   else (c_prev, 1))
        row("head", wbytes(c_in, 512, self.precision)
            + wbytes(512, 256, self.precision)
            + wbytes(256, cfg.n_classes, self.precision),
            4 * m * (512 + 256 + cfg.n_classes))
        return rows


def _path_stage(path: tuple) -> Optional[int]:
    """Stage index owning a param-tree path (None = embed/head)."""
    if path and path[0] == "stages" and len(path) > 1:
        return int(path[1])
    return None


def param_at(params: Dict, path: Tuple[Any, ...]):
    """Fetch the param subtree an op's ``path`` addresses."""
    node = params
    for p in path:
        node = node[p]
    return node


# ----------------------------------------------------------- lowering ---

def resolve_stage_fields(spec) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """``stage_precision`` / ``stage_backend`` as full 4-tuples."""
    prec = spec.stage_precision or (spec.precision,) * _N_STAGES
    back = spec.stage_backend or (spec.backend,) * _N_STAGES
    return tuple(prec), tuple(back)


def _quant_for(spec, precision: str,
               backend: str = "ref") -> Optional[QuantConfig]:
    """The deployment QuantConfig one CBR op runs under (None = fp32).

    An int8 op on the ``cuda`` backend runs W8A8 through the int8 kernel
    (``int8_cuda``), on the template that ``spec.kernel_tuning`` pins
    (``tiles``); on ``ref`` it runs the dequantized-weight matmul.
    Serving semantics quantize activations per lane.
    """
    if precision != "int8":
        return None
    common = dict(w_bits=min(spec.w_bits, 8), a_bits=spec.a_bits,
                  per_channel=spec.per_channel, symmetric=spec.symmetric,
                  per_lane=bool(spec.shared_urs and spec.per_sample_norm))
    if backend in _KERNEL_BACKENDS:
        return QuantConfig(backend="int8_cuda", tiles=kernel_tiles.pinned(
            "int8_matmul", spec.kernel_tuning), **common)
    return QuantConfig(backend="int8_ref", **common)


def _build_ops(cfg, make_cbr: Callable, head_quant: Optional[QuantConfig],
               fused_key: Optional[str] = None,
               fused_fn: Optional[Callable] = None,
               head: str = "cls", stream: bool = False,
               fps_tile: Optional[int] = None,
               knn_tile: Optional[int] = None,
               head_knn_tile: Optional[int] = None) -> Tuple[Any, ...]:
    ops: List[Any] = [EmbedOp(make_cbr(("embed",), None, True))]
    for s in range(_N_STAGES):
        ops.append(SampleOp(stage=s, n_samples=cfg.stage_samples[s],
                            cached=stream, tile=fps_tile))
        transfer = make_cbr(("stages", s, "transfer"), s, True)
        if fused_fn is not None:
            ops.append(FusedGroupTransferOp(
                stage=s, k=cfg.k_neighbors, cbr=transfer, kernel=fused_key,
                fn=fused_fn))
        else:
            ops.append(GroupOp(stage=s, k=cfg.k_neighbors, cached=stream,
                               tile=knn_tile))
            ops.append(transfer)
        for branch, count in (("pre", cfg.pre_blocks[s]),
                              ("pos", cfg.pos_blocks[s])):
            for i in range(count):
                base = ("stages", s, branch, i)
                ops.append(ResBlockOp(
                    stage=s, branch=branch, index=i,
                    net1=make_cbr(base + ("net1",), s, True),
                    net2=make_cbr(base + ("net2",), s, False)))
            if branch == "pre":
                ops.append(PoolOp(stage=s, axis=2))
    head_cls = HeadOp
    if head == "seg":
        head_cls = functools.partial(SegHeadOp, cached=stream,
                                     knn_tile=head_knn_tile)
    else:
        ops.append(PoolOp(stage=None, axis=1))
    ops.append(head_cls(fc1=make_cbr(("head", "fc1"), None, True),
                        fc2=make_cbr(("head", "fc2"), None, True),
                        fc3_path=("head", "fc3"), fc3_quant=head_quant))
    return tuple(ops)


def lower(spec, cfg) -> StagePlan:
    """Compile a spec + model config into the executable op plan.

    ``cfg`` supplies the topology, ``spec`` the policy.  Raises what
    ``api.spec.check_lowering`` raises: the ``lowering`` scope of
    ``repro_torch.analysis`` (the policy key is the engines' to check, as
    in ``repro.api.plan.lower``).

    Kernel tiles: each field ``spec.kernel_tuning`` pins (a value other
    than its default; ``repro_torch.kernels.tuning``) is checked against
    the tiles its kernel has on the card, on any device (``ValueError``
    naming them), and bound onto the ops that launch that kernel: a
    ``cuda`` CBR op's ``fn`` gets ``tile=`` (``fused_linear``), an int8
    one's ``quant.tiles`` (``int8_matmul``), the fused op's ``fn``
    ``tile_s=`` and ``knn_tile=``, a ``SampleOp`` the ``fps`` tile and a
    ``GroupOp`` (and the seg head's upsample) the ``knn`` tile, where the
    registered sampler or grouper launches that kernel (its
    ``tile_kernel``).  Default fields bind nothing.
    """
    check_lowering(spec)
    tuning = spec.kernel_tuning or DEFAULT_TUNING
    kernel_tiles.check(tuning)
    stage_prec, stage_back = resolve_stage_fields(spec)
    fused_key = spec.fused_group
    fused_fn = (registry.FUSED_OPS.get(fused_key)
                if fused_key != "none" else None)
    tiles = {k: kernel_tiles.pinned(k, tuning) for k in kernel_tiles.KERNELS}
    if fused_fn is not None and (tiles["grouped_transfer"] is not None
                                 or tiles["knn"] is not None):
        fused_fn = functools.partial(fused_fn,
                                     tile_s=tiles["grouped_transfer"],
                                     knn_tile=tiles["knn"])

    def make_cbr(path, stage, act) -> CBROp:
        precision = spec.precision if stage is None else stage_prec[stage]
        backend = spec.backend if stage is None else stage_back[stage]
        fn = registry.BACKENDS.get(backend)
        if backend in _KERNEL_BACKENDS and tiles["fused_linear"] is not None:
            fn = functools.partial(fn, tile=tiles["fused_linear"])
        return CBROp(path=tuple(path), stage=stage, act=act,
                     precision=precision, backend=backend,
                     quant=_quant_for(spec, precision, backend), fn=fn)

    def tile_of(component, kernel):
        return (tiles[kernel]
                if getattr(component, "tile_kernel", None) == kernel
                else None)

    ops = _build_ops(cfg, make_cbr,
                     _quant_for(spec, spec.precision, spec.backend),
                     fused_key=fused_key, fused_fn=fused_fn, head=spec.head,
                     stream=spec.stream,
                     fps_tile=tile_of(registry.SAMPLERS.get(spec.sampler),
                                      "fps"),
                     knn_tile=tile_of(registry.GROUPERS.get(spec.grouper),
                                      "knn"),
                     head_knn_tile=tiles["knn"])
    return StagePlan(name=spec.name, ops=ops, stage_precision=stage_prec,
                     stage_backend=stage_back, precision=spec.precision,
                     backend=spec.backend, fused_group=fused_key,
                     head=spec.head, stream=spec.stream, tuning=tuning)


def lower_config(cfg, backend_fn: Callable,
                 backend_key: str = "<resolved>") -> StagePlan:
    """A uniform plan from a :class:`PointMLPConfig` and one resolved
    backend callable, ``repro.api.plan.lower_config``'s twin: the route
    of ``pointmlp_apply`` (training and eval), so one interpreter serves
    both.

    Every CBR op gets ``backend_fn`` and the config's own quant (an
    enabled one fake-quantizes float weights), with ``per_lane=False``:
    this walk is not mapped over lanes, so the activation scale is one
    per tensor, the batch included.
    """
    quant = (dataclasses.replace(cfg.quant, per_lane=False)
             if cfg.quant.enabled else None)
    precision = "int8" if quant is not None else "fp32"

    def make_cbr(path, stage, act) -> CBROp:
        return CBROp(path=tuple(path), stage=stage, act=act,
                     precision=precision, backend=backend_key,
                     quant=quant, fn=backend_fn)

    return StagePlan(name=cfg.name,
                     ops=_build_ops(cfg, make_cbr, quant, head=cfg.head),
                     stage_precision=(precision,) * _N_STAGES,
                     stage_backend=(backend_key,) * _N_STAGES,
                     precision=precision, backend=backend_key,
                     head=cfg.head)


def spec_fingerprint(spec) -> str:
    """A deterministic 12-hex-digit fingerprint of a spec's field values
    (``repro.api.plan.spec_fingerprint``'s): two specs share it iff
    their fields agree, with an unset ``stage_precision`` /
    ``stage_backend`` hashed as the inherited 4-tuple.  ``build_pool``
    dedupes its freeze on it."""
    d = dataclasses.asdict(spec)
    prec, back = resolve_stage_fields(spec)
    d["stage_precision"], d["stage_backend"] = list(prec), list(back)
    blob = json.dumps(d, sort_keys=True, default=str, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def spec_label(spec) -> str:
    """The searched axes of a spec in one short string, the tuner's row
    name (``repro.api.plan.spec_label``'s format, so a row keeps its name
    across revisions and packages).  A non-default ``kernel_tuning``
    appends a ``/kt=`` token."""
    prec, back = resolve_stage_fields(spec)
    label = (f"{spec.sampler}/{spec.grouper}"
             f"/prec={'.'.join(prec)}+{spec.precision}"
             f"/be={back[0] if len(set(back)) == 1 else '.'.join(back)}"
             f"/fg={spec.fused_group}"
             f"/ds={spec.data_shards}")
    kt = spec.kernel_tuning
    if kt is not None and kt != DEFAULT_TUNING:
        tm, tk, tn = kt.fused_linear
        label += (f"/kt={tm}x{tk}x{tn}.gt{kt.grouped_transfer}"
                  f".f{kt.fps}.k{kt.knn}")
    return label


#: The per-stage precision ladder the tuner searches: the two uniform
#: ends and the paper-style mixes that keep the tail in fp32.
DEFAULT_STAGE_PRECISIONS: Tuple[Tuple[str, ...], ...] = (
    ("fp32",) * _N_STAGES,
    ("int8",) * _N_STAGES,
    ("int8", "int8", "int8", "fp32"),
    ("int8", "int8", "fp32", "fp32"),
)


def enumerate_plan_space(base,
                         *,
                         stage_precisions: Iterable = DEFAULT_STAGE_PRECISIONS,
                         stage_backends: Iterable = (("ref",) * _N_STAGES,),
                         fused_groups: Iterable = ("none",),
                         data_shards: Iterable = (1,),
                         samplers: Optional[Iterable] = None,
                         groupers: Optional[Iterable] = None,
                         kernel_tunings: Iterable = (None,)) -> List:
    """The valid spec search space around ``base``.

    The product ``stage_precision`` x ``stage_backend`` x ``fused_group``
    x ``data_shards`` x sampler x grouper x ``kernel_tuning``, in argument
    order, less every point with a finding of the analyzer's lowering
    passes (an error or a warning).  A ``kernel_tunings`` entry of None
    keeps ``base.kernel_tuning``.
    """
    from repro_torch.analysis.passes import analyze_spec
    samplers = tuple(samplers) if samplers is not None else (base.sampler,)
    groupers = tuple(groupers) if groupers is not None else (base.grouper,)
    out = []
    for sp, sb, fg, ds, sam, grp, kt in itertools.product(
            tuple(tuple(p) for p in stage_precisions),
            tuple(tuple(b) for b in stage_backends),
            tuple(fused_groups), tuple(data_shards),
            samplers, groupers, tuple(kernel_tunings)):
        spec = base.replace(stage_precision=sp, stage_backend=sb,
                            fused_group=fg, data_shards=ds,
                            sampler=sam, grouper=grp)
        if kt is not None:
            spec = spec.replace(kernel_tuning=kt)
        if analyze_spec(spec, scopes=("lowering",)):
            continue
        out.append(spec)
    return out
