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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

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


def build(spec: PipelineSpec, params: Dict, *, device=None
          ) -> "FrozenPipeline":
    """Compile a spec + trained params into a frozen pipeline on
    ``device`` (default ``cuda``; raises without a GPU).

    ``params`` is the port's tree (``repro_torch.convert.
    from_numpy_tree`` carries a JAX tree across); a tree that is already
    frozen (int8 export dicts, no BN) passes through the freeze
    unchanged.  Spec values this slice does not run raise
    ``NotImplementedError`` naming their ROADMAP.md item.
    """
    dev = resolve_device(device)
    frozen, cfg, plan = _freeze(spec, params)       # lower() validates
    sampler, grouper, _ = registry.resolve(spec.sampler, spec.grouper,
                                           spec.backend)
    return FrozenPipeline(spec=spec, params=to_device(frozen, dev),
                          model_config=cfg, plan=plan, device=dev,
                          sampler=sampler, grouper=grouper)


@dataclasses.dataclass(frozen=True)
class FrozenPipeline:
    """Frozen params + the resolved walk on one device (from
    :func:`build`)."""
    spec: PipelineSpec
    params: Dict
    model_config: Any
    plan: Any
    device: torch.device
    sampler: Any = dataclasses.field(repr=False, default=None)
    grouper: Any = dataclasses.field(repr=False, default=None)

    def infer(self, pts, lfsr_state: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Run the pipeline on ``pts`` [B, N, 3] (tensor or array).

        ``lfsr_state`` holds one LFSR stream per lane (URS specs); it is
        advanced on the host.  Returns (logits [B, n_classes], or [B,
        n_points, n_classes] for the seg head, on the pipeline's device;
        advanced state as a CPU int64 tensor).
        """
        from repro_torch.models import pointmlp as PM
        if isinstance(pts, np.ndarray):
            pts = torch.from_numpy(pts)
        pts = pts.to(self.device, torch.float32)
        if (lfsr_state is not None and pts.ndim >= 1
                and lfsr_state.shape[0] < pts.shape[0]):
            raise ValueError(
                f"LFSR state has {lfsr_state.shape[0]} streams for a batch "
                f"of {pts.shape[0]}; size it from the dispatch batch, e.g. "
                f"pipeline.seed_state(seed, max_batch)")
        return PM.pointmlp_infer_with(
            self.params, self.model_config, pts, lfsr_state,
            sampler=self.sampler, grouper=self.grouper, plan=self.plan,
            shared_urs=self.spec.shared_urs,
            per_sample_norm=self.spec.per_sample_norm)

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
            f"  flops     : {self.flops() / 1e6:.1f} MFLOP/sample",
            f"  params    : {tree_size_bytes(self.params)} bytes",
            f"  plan      : {len(self.plan.ops)} ops; {self.plan.describe()}",
        ])


def _sampler_note(spec: PipelineSpec) -> str:
    if spec.sampler == "fps":
        return " (farthest point, per cloud)"
    return " (shared across batch)" if spec.shared_urs else ""
