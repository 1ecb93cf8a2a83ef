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
the plan.  :func:`spec_fingerprint` names a spec by its field values.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.api import registry
from repro_torch.api.spec import N_STAGES as _N_STAGES
from repro_torch.api.spec import check_lowering
from repro_torch.core.quant import QuantConfig, is_quantizable_leaf_path

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
    either way.
    """
    stage: int
    n_samples: int
    cached: bool = False


@dataclasses.dataclass(frozen=True)
class GroupOp:
    """(xyz, feats, idx) -> (new_xyz, centre feats, grouped [B,S,k,2C]).

    ``cached`` (stream lowering) splits the grouper into its mapping half
    (``neighbor_index``, replayed from the stream cache) and its
    arithmetic half (``group_with_idx``, always recomputed).
    """
    stage: int
    k: int
    cached: bool = False


@dataclasses.dataclass(frozen=True)
class FusedGroupTransferOp:
    """A ``GroupOp`` + transfer ``CBROp`` pair lowered to one fused
    gather + geometric-affine-normalize + matmul+bias+ReLU step
    (``repro_torch.api.registry.FUSED_OPS[kernel]``); the grouped
    ``[B, S, k, 2C]`` tensor never leaves the kernel."""
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
    the upsample index from a stream cache."""
    fc1: CBROp
    fc2: CBROp
    fc3_path: Tuple[Any, ...]
    fc3_quant: Optional[QuantConfig] = dataclasses.field(compare=False,
                                                         default=None)
    cached: bool = False


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
        return "; ".join(rows)


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
    (``int8_cuda``); on ``ref`` it runs the dequantized-weight matmul.
    Serving semantics quantize activations per lane.
    """
    if precision != "int8":
        return None
    common = dict(w_bits=min(spec.w_bits, 8), a_bits=spec.a_bits,
                  per_channel=spec.per_channel, symmetric=spec.symmetric,
                  per_lane=bool(spec.shared_urs and spec.per_sample_norm))
    if backend in _KERNEL_BACKENDS:
        return QuantConfig(backend="int8_cuda", **common)
    return QuantConfig(backend="int8_ref", **common)


def _build_ops(cfg, make_cbr: Callable, head_quant: Optional[QuantConfig],
               fused_key: Optional[str] = None,
               fused_fn: Optional[Callable] = None,
               head: str = "cls", stream: bool = False) -> Tuple[Any, ...]:
    ops: List[Any] = [EmbedOp(make_cbr(("embed",), None, True))]
    for s in range(_N_STAGES):
        ops.append(SampleOp(stage=s, n_samples=cfg.stage_samples[s],
                            cached=stream))
        transfer = make_cbr(("stages", s, "transfer"), s, True)
        if fused_fn is not None:
            ops.append(FusedGroupTransferOp(
                stage=s, k=cfg.k_neighbors, cbr=transfer, kernel=fused_key,
                fn=fused_fn))
        else:
            ops.append(GroupOp(stage=s, k=cfg.k_neighbors, cached=stream))
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
        head_cls = functools.partial(SegHeadOp, cached=stream)
    else:
        ops.append(PoolOp(stage=None, axis=1))
    ops.append(head_cls(fc1=make_cbr(("head", "fc1"), None, True),
                        fc2=make_cbr(("head", "fc2"), None, True),
                        fc3_path=("head", "fc3"), fc3_quant=head_quant))
    return tuple(ops)


def lower(spec, cfg) -> StagePlan:
    """Compile a spec + model config into the executable op plan.

    ``cfg`` supplies the topology, ``spec`` the policy.  Raises what
    ``api.spec.check_lowering`` raises (the policy key is the engines'
    to check, as in ``repro.api.plan.lower``).
    """
    check_lowering(spec)
    stage_prec, stage_back = resolve_stage_fields(spec)
    fused_key = spec.fused_group
    fused_fn = (registry.FUSED_OPS.get(fused_key)
                if fused_key != "none" else None)

    def make_cbr(path, stage, act) -> CBROp:
        precision = spec.precision if stage is None else stage_prec[stage]
        backend = spec.backend if stage is None else stage_back[stage]
        return CBROp(path=tuple(path), stage=stage, act=act,
                     precision=precision, backend=backend,
                     quant=_quant_for(spec, precision, backend),
                     fn=registry.BACKENDS.get(backend))

    ops = _build_ops(cfg, make_cbr,
                     _quant_for(spec, spec.precision, spec.backend),
                     fused_key=fused_key, fused_fn=fused_fn, head=spec.head,
                     stream=spec.stream)
    return StagePlan(name=spec.name, ops=ops, stage_precision=stage_prec,
                     stage_backend=stage_back, precision=spec.precision,
                     backend=spec.backend, fused_group=fused_key,
                     head=spec.head, stream=spec.stream)


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
