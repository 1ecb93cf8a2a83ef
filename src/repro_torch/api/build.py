"""``build(spec, params) -> FrozenPipeline``: the one-shot pipeline compiler.

The twin of ``repro.api.build``: fold BN into (w, b) (``spec.fuse``),
lower the stage plan, export the int8 regions, resolve the registry keys
and place the frozen params on the device::

    pipe = build(lite_spec(n_classes).serving(), params)    # on cuda
    logits, state = pipe.infer(pts, pipe.seed_state(0, batch))

``device=None`` means ``cuda`` and raises when no GPU is present; pass
``device="cpu"`` to run the plain versions on the CPU.  The freeze runs
on the CPU whatever the target device, so a CPU and a CUDA pipeline
built from the same params hold bit-identical weights.

A ``stream=True`` spec adds :meth:`FrozenPipeline.infer_collect` and
:meth:`FrozenPipeline.infer_cached`, the two passes of a stream session.
A spec with ``data_shards > 1`` dispatches every pass through
``repro_torch.serve.sharding.shard_forward`` over a ``("data",)`` mesh
(the first CUDA devices, or the ``mesh`` passed), bit for bit the
unsharded pipeline.  :func:`build_pool` builds a fleet's pool, one
pipeline per replica.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.api import registry
from repro_torch.api.spec import PipelineSpec


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raising without a GPU); else the device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def to_device(tree: Any, device) -> Any:
    """Move every tensor leaf of a nested dict/list tree to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def _freeze(spec: PipelineSpec, params: Dict) -> Tuple[Dict, Any, Any]:
    """Fuse BN, lower the plan, selectively export int8 (on the CPU).

    Returns ``(frozen_params, deploy_cfg, plan)``.
    """
    from repro_torch.api import plan as stage_plan
    from repro_torch.core import fusion
    from repro_torch.core.quant import QuantConfig, quantize_tree

    cfg = spec.to_model_config()
    frozen = to_device(params, "cpu")
    if spec.fuse:
        frozen, cfg = fusion.fuse_pointmlp(frozen, cfg)
    plan = stage_plan.lower(spec, cfg)
    fp32 = QuantConfig(w_bits=32, a_bits=32)
    if plan.any_int8:
        qcfg = QuantConfig(w_bits=min(spec.w_bits, 8), a_bits=spec.a_bits,
                           per_channel=spec.per_channel,
                           symmetric=spec.symmetric, backend="int8_ref")
        frozen = quantize_tree(frozen, qcfg, predicate=plan.quant_predicate())
        cfg = cfg.replace(quant=qcfg if spec.precision == "int8" else fp32)
    else:
        cfg = cfg.replace(quant=fp32)
    return frozen, cfg, plan


def build(spec: PipelineSpec, params: Dict, *, device=None, mesh=None
          ) -> "FrozenPipeline":
    """Compile a spec + trained params into a frozen pipeline on
    ``device`` (default ``cuda``; raises without a GPU).

    ``params`` is the port's tree (``repro_torch.convert.
    from_numpy_tree`` carries a JAX tree across); a tree that is already
    frozen (int8 export dicts, no BN) passes through the freeze
    unchanged.

    A sharded spec (``data_shards > 1``) dispatches over ``mesh``, a 1-D
    ``("data",)`` :class:`~repro_torch.serve.sharding.LocalMesh` of
    ``data_shards`` devices (fleet placement passes each replica's
    ``replica_submesh`` row), or by default over the first
    ``data_shards`` CUDA devices; the params are copied once to each
    distinct device of the mesh, and the pipeline's ``device`` (where
    its logits land) is the mesh's first.  ``device``, if given, must be
    that device.  A mesh for an unsharded spec raises ``ValueError``.
    """
    _enforce_placement(spec)           # RPA020, before the freeze
    frozen, cfg, plan = _freeze(spec, params)       # lower() validates
    return _place(spec, frozen, cfg, plan, device, mesh)


def _place(spec: PipelineSpec, frozen: Dict, cfg, plan, device, mesh
           ) -> "FrozenPipeline":
    """Put a frozen tree on its device (each device of its mesh) and
    resolve the walk."""
    sampler, grouper, _ = registry.resolve(spec.sampler, spec.grouper,
                                           spec.backend)
    shard_params = None
    if spec.data_shards > 1:
        from repro_torch.serve.sharding import make_mesh
        if mesh is None:
            mesh = make_mesh(spec.data_shards)
        dev = mesh.devices.flat[0]
        if device is not None and not _same_device(torch.device(device),
                                                   dev):
            raise ValueError(
                f"build() was given device={device!r} and a mesh whose "
                f"first device is {dev}: a sharded pipeline's logits land "
                f"on its mesh's first device (pass device=None)")
        shard_params = {d: to_device(frozen, d)
                        for d in mesh.distinct_devices()}
        placed = shard_params[dev]
    elif mesh is not None:
        raise ValueError(
            "build() was given a placement mesh but spec.data_shards "
            "== 1 — an unsharded pipeline has no mesh to place on "
            "(set spec.data_shards to the mesh's data axis)")
    else:
        dev = resolve_device(device)
        placed = to_device(frozen, dev)
    return FrozenPipeline(spec=spec, params=placed, model_config=cfg,
                          plan=plan, device=dev, sampler=sampler,
                          grouper=grouper, mesh=mesh,
                          shard_params=shard_params)


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``a`` names ``b`` (a CUDA device without an index names any)."""
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def build_pool(specs: Sequence[PipelineSpec],
               params_by_name: Mapping[str, Dict], *, device=None,
               mesh=None) -> List["FrozenPipeline"]:
    """A fleet's pool: one :class:`FrozenPipeline` per spec of ``specs``
    (``FleetSpec.pool_specs()``), on ``device`` (default ``cuda``).

    Replicas of one (:func:`~repro_torch.api.plan.spec_fingerprint`,
    params) pair share one freeze; unsharded ones share the whole
    pipeline object (on one device they are interchangeable).
    ``params_by_name`` maps each ``spec.name`` to its parameter tree; a
    missing name raises ``KeyError`` listing what was given.

    The specs must agree on ``data_shards``.  A sharded pool places
    replica ``i`` on row ``i`` of ``mesh``, a ``("replica", "data")``
    :class:`~repro_torch.serve.sharding.LocalMesh` with one row per
    spec (by default :func:`~repro_torch.serve.sharding.make_mesh2d`
    over the first CUDA devices), each replica with its own pipeline.
    A mesh for an unsharded pool raises ``ValueError``.
    """
    from repro_torch.api import plan as stage_plan
    specs = list(specs)
    shards = {s.data_shards for s in specs}
    if len(shards) > 1:
        raise ValueError(f"pool specs must agree on data_shards (the "
                         f"replica x data mesh is rectangular), got "
                         f"{sorted(shards)}")
    data_shards = shards.pop() if specs else 1
    if data_shards > 1:
        from repro_torch.serve.sharding import make_mesh2d, replica_submesh
        if mesh is None:
            mesh = make_mesh2d(len(specs), data_shards)
        if tuple(mesh.axis_names) != ("replica", "data") \
                or mesh.devices.shape[0] != len(specs):
            raise ValueError(
                f"build_pool needs a ('replica', 'data') mesh with one "
                f"row per pool spec ({len(specs)}); got axes "
                f"{tuple(mesh.axis_names)} shape {mesh.devices.shape}")
    elif mesh is not None:
        raise ValueError("build_pool was given a mesh but the pool is "
                         "unsharded (data_shards == 1)")
    frozen: Dict[Tuple[str, int], Tuple] = {}
    shared: Dict[Tuple[str, int], FrozenPipeline] = {}
    pool: List[FrozenPipeline] = []
    for i, spec in enumerate(specs):
        try:
            params = params_by_name[spec.name]
        except KeyError:
            raise KeyError(
                f"build_pool: no params for pool pipeline {spec.name!r}; "
                f"params_by_name has "
                f"{', '.join(map(repr, params_by_name))}") from None
        key = (stage_plan.spec_fingerprint(spec), id(params))
        if key not in frozen:
            _enforce_placement(spec)
            frozen[key] = _freeze(spec, params)
        if data_shards > 1:
            pool.append(_place(spec, *frozen[key], device,
                               replica_submesh(mesh, i)))
            continue
        if key not in shared:
            shared[key] = _place(spec, *frozen[key], device, None)
        pool.append(shared[key])
    return pool


def _enforce_placement(spec: PipelineSpec) -> None:
    """The ``placement`` scope of ``repro_torch.analysis`` (RPA020)."""
    from repro_torch.analysis.passes import enforce_spec
    enforce_spec(spec, scopes=("placement",))


@dataclasses.dataclass(frozen=True)
class FrozenPipeline:
    """Frozen params + the resolved walk on one device, or split over a
    ``("data",)`` mesh (from :func:`build`).

    ``mesh`` is None for an unsharded spec.  A sharded pipeline keeps
    one params copy per distinct mesh device in ``shard_params``
    (``params`` is the first device's) and dispatches every pass through
    ``repro_torch.serve.sharding.shard_forward``."""
    spec: PipelineSpec
    params: Dict
    model_config: Any
    plan: Any
    device: torch.device
    sampler: Any = dataclasses.field(repr=False, default=None)
    grouper: Any = dataclasses.field(repr=False, default=None)
    mesh: Any = None
    shard_params: Optional[Dict] = dataclasses.field(repr=False,
                                                     default=None)
    _dispatch: Dict = dataclasses.field(init=False, repr=False,
                                        default=None)

    def __post_init__(self):
        if self.mesh is None:
            return
        from repro_torch.serve.sharding import shard_forward
        walk, spec, mesh = self._walk, self.spec, self.mesh
        dispatch = {None: shard_forward(walk, spec, mesh)[0]}
        if self.plan.stream:
            dispatch["collect_cache"] = shard_forward(
                lambda p, x, s: walk(p, x, s, collect_cache=True), spec,
                mesh, cache_out=True)[0]
            dispatch["mapping_cache"] = shard_forward(
                lambda p, x, s, c: walk(p, x, s, mapping_cache=c), spec,
                mesh, cache_in=True)[0]
        object.__setattr__(self, "_dispatch", dispatch)

    def infer(self, pts, lfsr_state: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Run the pipeline on ``pts`` [B, N, 3] (tensor or array).

        ``lfsr_state`` holds one LFSR stream per lane (URS specs); it is
        advanced on the host.  Returns (logits [B, n_classes], or [B,
        n_points, n_classes] for the seg head, on the pipeline's device;
        advanced state as a CPU int64 tensor).
        """
        return self._run(pts, lfsr_state)

    def _run(self, pts, lfsr_state, **cache_kw):
        if isinstance(pts, np.ndarray):
            pts = torch.from_numpy(pts)
        if (lfsr_state is not None and pts.ndim >= 1
                and lfsr_state.shape[0] < pts.shape[0]):
            raise ValueError(
                f"LFSR state has {lfsr_state.shape[0]} streams for a batch "
                f"of {pts.shape[0]}; size it from the dispatch batch, e.g. "
                f"pipeline.seed_state(seed, max_batch)")
        if self.mesh is None:
            if "mapping_cache" in cache_kw:
                cache_kw["mapping_cache"] = to_device(
                    cache_kw["mapping_cache"], self.device)
            return self._walk(self.params, pts.to(self.device,
                                                  torch.float32),
                              lfsr_state, **cache_kw)
        # each shard moves its own lanes (and cache rows) to its device
        pts = pts.to(dtype=torch.float32)
        if "mapping_cache" in cache_kw:
            return self._dispatch["mapping_cache"](
                self.shard_params, pts, lfsr_state,
                cache_kw["mapping_cache"])
        kind = "collect_cache" if cache_kw.get("collect_cache") else None
        return self._dispatch[kind](self.shard_params, pts, lfsr_state)

    def _walk(self, params, pts, lfsr_state, **cache_kw):
        from repro_torch.models import pointmlp as PM
        return PM.pointmlp_infer_with(
            params, self.model_config, pts, lfsr_state,
            sampler=self.sampler, grouper=self.grouper, plan=self.plan,
            shared_urs=self.spec.shared_urs,
            per_sample_norm=self.spec.per_sample_norm, **cache_kw)

    @property
    def streaming(self) -> bool:
        """Whether the plan was lowered with cache-aware mapping ops
        (``spec.stream=True``): :meth:`infer_collect` and
        :meth:`infer_cached` need it."""
        return bool(self.plan.stream)

    def _require_streaming(self, what: str) -> None:
        if not self.streaming:
            raise ValueError(
                f"{what} needs a streaming pipeline; build one from a spec "
                f"with stream=True (e.g. spec.replace(stream=True, "
                f"stream_drift_threshold=...))")

    def infer_collect(self, pts, lfsr_state: Optional[torch.Tensor] = None):
        """The cold pass of a stream: :meth:`infer` (the same logits and
        state, bit for bit) and the mapping cache it computed, ``{"sample":
        (idx, ...), "nbr": (nbr, ...)[, "up": idx]}``, batch-leading
        tensors on the pipeline's device.

        Returns (logits, advanced LFSR state, cache).
        """
        self._require_streaming("infer_collect")
        return self._run(pts, lfsr_state, collect_cache=True)

    def infer_cached(self, pts, lfsr_state: Optional[torch.Tensor], cache
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The cached pass: the mapping ops replay ``cache`` (from
        :meth:`infer_collect`, one row per lane of ``pts``); the
        arithmetic recomputes on the frame's own points.

        Returns (logits, advanced LFSR state).
        """
        self._require_streaming("infer_cached")
        return self._run(pts, lfsr_state, mapping_cache=cache)

    def seed_state(self, seed: int, n_streams: int = 64) -> torch.Tensor:
        """Fresh LFSR streams (the paper's "same starting states"); size
        ``n_streams`` from the dispatch batch."""
        from repro_torch.core import sampling
        return sampling.seed_streams(seed, n_streams)

    def flops(self) -> int:
        """Analytic MAC*2 count per sample."""
        from repro_torch.models import pointmlp as PM
        return PM.pointmlp_flops(self.model_config)

    def flops_breakdown(self) -> Dict[str, int]:
        """Per-stage-op MAC*2 counts (sums to :meth:`flops`)."""
        from repro_torch.models import pointmlp as PM
        return PM.pointmlp_flops_breakdown(self.model_config)

    def cost_breakdown(self) -> List[Dict[str, Any]]:
        """Per-op FLOPs, weight bytes and activation bytes of the compiled
        plan (:meth:`~repro_torch.api.plan.StagePlan.cost_breakdown`)."""
        return self.plan.cost_breakdown(self.model_config)

    def describe(self) -> str:
        """Human-readable rendering of the compiled variant."""
        from repro_torch.core.quant import tree_size_bytes
        s, cfg = self.spec, self.model_config
        mm = "int8_cuda" if s.backend == "cuda" else "int8_ref"
        prec = (f"int8 (w{min(s.w_bits, 8)}/a{s.a_bits}, {mm} matmul)"
                if s.precision == "int8" else "fp32")
        return "\n".join([
            f"FrozenPipeline({s.name})",
            f"  topology  : {s.n_points} pts -> stages {cfg.stage_samples} "
            f"x dims {cfg.stage_dims} -> {s.n_classes} classes"
            + (" per point (seg head)" if s.head == "seg" else ""),
            f"  sampler   : {s.sampler}" + _sampler_note(s),
            f"  grouper   : {s.grouper} (k={s.k_neighbors}"
            + (f", radius {self.grouper.radius}"
               if hasattr(self.grouper, "radius") else "")
            + f", {s.affine_mode}"
            + (", per-sample sigma)" if s.per_sample_norm else ")")
            + (f" fused with the transfer layer: {s.fused_group}"
               if s.fused_group != "none" else ""),
            f"  precision : {prec}",
            f"  fusion    : {'BN folded into (w, b)' if s.fuse else 'off'}",
            f"  backend   : {s.backend}",
            f"  device    : {self.device}",
            f"  sharding  : " + (
                f"{s.data_shards}-way data-parallel over mesh axis 'data' "
                f"({', '.join(map(str, self.mesh.devices.flat))})"
                if self.mesh is not None else "single-device"),
            f"  flops     : {self.flops() / 1e6:.1f} MFLOP/sample",
            f"  params    : {tree_size_bytes(self.params)} bytes",
            f"  plan      : {len(self.plan.ops)} ops; {self.plan.describe()}",
        ])


def _sampler_note(spec: PipelineSpec) -> str:
    if spec.sampler == "fps":
        return " (farthest point, per cloud)"
    return " (shared across batch)" if spec.shared_urs else ""
