"""PipelineSpec: the declarative description of one pipeline variant.

The port's twin of ``repro.api.spec.PipelineSpec``, with the same field
names and defaults (a parity test pins them), so a spec reads the same
on both sides.  The paper's ladder as data::

    elite_spec()   # FPS, learnable geometric affine, fp32, 1024 points
    m2_spec()      # URS, alpha/beta pruned, fp32, 512 points
    lite_spec()    # M-2 topology + int8 w8/a8 deployment
    compression_ladder_specs()   # Table 1: Elite, M-1 .. M-4, Lite

Backend keys: ``ref`` (plain PyTorch) and ``cuda`` (the hand-written
kernels; the port's counterpart of ``pallas``).  ``fused_group=
"grouped_transfer"`` lowers each stage's group + transfer pair to one
fused kernel.  Spec values the port does not run yet are rejected by
:meth:`PipelineSpec.validate` with a ``NotImplementedError`` naming the
ROADMAP.md item they wait for; a fused group whose preconditions fail
(``repro.analysis`` RPA010-012) raises ``ValueError``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.kernels.tuning import DEFAULT_TUNING, KernelTuning

PRECISIONS = ("fp32", "int8")
AFFINE_MODES = ("affine", "norm", "center")
HEADS = ("cls", "seg")
N_STAGES = 4


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """One pipeline variant, fully described (see ``repro.api.spec``).

    Topology fields mirror :class:`repro_torch.models.pointmlp.
    PointMLPConfig`; component fields are registry keys
    (``repro_torch.api.registry``); ``precision`` / ``w_bits`` /
    ``a_bits`` / ``fuse`` are the deployment policy; ``shared_urs`` and
    ``per_sample_norm`` are the serving batch semantics (see
    :meth:`serving`).  The streaming, sharding and async-policy fields
    exist so specs mirror the JAX ones; the slices that run them are
    listed in ROADMAP.md.
    """
    name: str = "pointmlp-elite"
    # ---- topology (PointMLP walk) ----
    n_points: int = 1024
    n_classes: int = 40
    embed_dim: int = 32
    k_neighbors: int = 16
    stage_expansion: Tuple[int, ...] = (2, 2, 2, 2)
    pre_blocks: Tuple[int, ...] = (1, 1, 2, 1)
    pos_blocks: Tuple[int, ...] = (1, 1, 2, 1)
    res_expansion: float = 0.25
    affine_mode: str = "affine"
    # ---- components (registry keys) ----
    sampler: str = "fps"
    grouper: str = "knn"
    backend: str = "ref"
    # ---- precision / fusion policy ----
    precision: str = "fp32"
    w_bits: int = 8
    a_bits: int = 8
    per_channel: bool = True
    symmetric: bool = True
    fuse: bool = True
    # ---- per-stage overrides: 4-tuples, None inherits the spec-level
    # field; embed and head always follow the spec-level fields ----
    stage_precision: Optional[Tuple[str, ...]] = None
    stage_backend: Optional[Tuple[str, ...]] = None
    fused_group: str = "none"
    head: str = "cls"
    stream: bool = False
    stream_drift_threshold: float = 0.0
    kernel_tuning: Optional[KernelTuning] = None
    # ---- batch semantics ----
    shared_urs: bool = False
    per_sample_norm: bool = False
    data_shards: int = 1
    # ---- serving policy (async engine) ----
    policy: str = "fixed"
    slo_ms: float = 0.0
    dispatch_ms: float = 0.0

    def __post_init__(self):
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, "
                             f"got {self.precision!r}")
        if self.affine_mode not in AFFINE_MODES:
            raise ValueError(f"affine_mode must be one of {AFFINE_MODES}, "
                             f"got {self.affine_mode!r}")
        if self.slo_ms < 0:
            raise ValueError(f"slo_ms must be >= 0, got {self.slo_ms!r}")
        if self.dispatch_ms < 0:
            raise ValueError(
                f"dispatch_ms must be >= 0, got {self.dispatch_ms!r}")
        if not isinstance(self.data_shards, int) or self.data_shards < 1:
            raise ValueError(f"data_shards must be a positive int, "
                             f"got {self.data_shards!r}")
        for field, allowed in (("stage_precision", PRECISIONS),
                               ("stage_backend", None)):
            val = getattr(self, field)
            if val is None:
                continue
            if isinstance(val, list):        # normalize to a hashable spec
                val = tuple(val)
                object.__setattr__(self, field, val)
            if (not isinstance(val, tuple) or len(val) != N_STAGES
                    or not all(isinstance(v, str) for v in val)):
                raise ValueError(
                    f"{field} must be a {N_STAGES}-tuple of strings "
                    f"(one per stage), got {val!r}")
            if allowed is not None and not set(val) <= set(allowed):
                raise ValueError(
                    f"{field} entries must be in {allowed}, got {val!r}")
        if not isinstance(self.fused_group, str):
            raise ValueError(f"fused_group must be a registry key or "
                             f"'none', got {self.fused_group!r}")
        if (self.kernel_tuning is not None
                and not isinstance(self.kernel_tuning, KernelTuning)):
            raise ValueError(f"kernel_tuning must be a repro_torch.kernels."
                             f"tuning.KernelTuning or None, "
                             f"got {self.kernel_tuning!r}")
        if self.head not in HEADS:
            raise ValueError(f"head must be one of {HEADS}, "
                             f"got {self.head!r}")
        if not isinstance(self.stream, bool):
            raise ValueError(f"stream must be a bool, got {self.stream!r}")
        thr = self.stream_drift_threshold
        if (not isinstance(thr, (int, float)) or isinstance(thr, bool)
                or not thr >= 0 or thr == float("inf")):
            raise ValueError(f"stream_drift_threshold must be a finite "
                             f"float >= 0, got {thr!r}")

    def replace(self, **kw) -> "PipelineSpec":
        return dataclasses.replace(self, **kw)

    def serving(self, policy: Optional[str] = None,
                slo_ms: Optional[float] = None,
                dispatch_ms: Optional[float] = None,
                data_shards: Optional[int] = None) -> "PipelineSpec":
        """The streaming-deployment rendering of this spec: one URS
        sequence serves the batch and every cloud normalizes with its own
        statistics, so a lane's result is independent of its dispatch."""
        kw = dict(shared_urs=True, per_sample_norm=True)
        for name, val in (("policy", policy), ("slo_ms", slo_ms),
                          ("dispatch_ms", dispatch_ms),
                          ("data_shards", data_shards)):
            if val is not None:
                kw[name] = val
        return self.replace(**kw)

    def validate(self) -> "PipelineSpec":
        """Reject what the port does not run (``NotImplementedError``
        naming the ROADMAP.md item), unknown registry keys (``KeyError``
        listing the registered names) and a fused group whose
        preconditions fail (``ValueError``).  Returns self."""
        _check_supported(self)
        from repro_torch.api import registry
        registry.SAMPLERS.get(self.sampler)
        registry.GROUPERS.get(self.grouper)
        for key in {self.backend, *(self.stage_backend or ())}:
            registry.BACKENDS.get(key)
        if self.fused_group != "none":
            registry.FUSED_OPS.get(self.fused_group)
            _check_fused(self)
        return self

    # ------------------------------------------- model-config bridge ----

    def to_model_config(self):
        """The training-shape :class:`PointMLPConfig` of this spec
        (``build`` derives the deployment config from it)."""
        from repro_torch.core.quant import QuantConfig
        from repro_torch.models.pointmlp import PointMLPConfig
        if self.precision == "int8":
            quant = QuantConfig(w_bits=self.w_bits, a_bits=self.a_bits,
                                per_channel=self.per_channel,
                                symmetric=self.symmetric)
        else:
            quant = QuantConfig(w_bits=32, a_bits=32)
        return PointMLPConfig(
            name=self.name, n_points=self.n_points, n_classes=self.n_classes,
            embed_dim=self.embed_dim, k_neighbors=self.k_neighbors,
            stage_expansion=self.stage_expansion, pre_blocks=self.pre_blocks,
            pos_blocks=self.pos_blocks, res_expansion=self.res_expansion,
            sampler=self.sampler, affine_mode=self.affine_mode,
            head=self.head, quant=quant)

    @classmethod
    def from_model_config(cls, cfg, **overrides) -> "PipelineSpec":
        """Lift a :class:`PointMLPConfig` into a spec.

        An enabled quant config maps to ``precision="int8"`` with its w/a
        bits and scale policy kept exactly (so :meth:`to_model_config`
        round-trips; ``build`` clamps w_bits to 8 at the export).  Pass
        ``precision="fp32"`` in ``overrides`` to serve the fused-fp32
        deployment of a quantized config.
        """
        fields = dict(
            name=cfg.name, n_points=cfg.n_points, n_classes=cfg.n_classes,
            embed_dim=cfg.embed_dim, k_neighbors=cfg.k_neighbors,
            stage_expansion=cfg.stage_expansion, pre_blocks=cfg.pre_blocks,
            pos_blocks=cfg.pos_blocks, res_expansion=cfg.res_expansion,
            sampler=cfg.sampler, affine_mode=cfg.affine_mode,
            head=cfg.head, precision="fp32")
        if cfg.quant.enabled:
            fields.update(precision="int8", w_bits=cfg.quant.w_bits,
                          a_bits=cfg.quant.a_bits,
                          per_channel=cfg.quant.per_channel,
                          symmetric=cfg.quant.symmetric)
        fields.update(overrides)
        return cls(**fields)


#: Spec values the port does not run yet, and the ROADMAP.md item each
#: waits for.
_WAITS = (
    (lambda s: s.stream, "stream=True", "the async/stream/fleet engines"),
    (lambda s: s.data_shards > 1, "data_shards > 1",
     "the async/stream/fleet engines (sharded dispatch)"),
    (lambda s: s.kernel_tuning not in (None, DEFAULT_TUNING),
     "a non-default kernel_tuning", "Tuning and analysis"),
)


def _check_supported(spec: PipelineSpec) -> None:
    for test, what, item in _WAITS:
        if test(spec):
            raise NotImplementedError(
                f"{what} is not ported yet: it waits for '{item}' in "
                f"ROADMAP.md (Queue 1)")


def _check_fused(spec: PipelineSpec) -> None:
    """What the fused group->transfer lowering needs (``repro.analysis``
    RPA010-012), as ``ValueError``s that name the field to change."""
    fused = spec.fused_group
    if spec.grouper != "knn":
        raise ValueError(
            f"RPA010: fused_group={fused!r} builds its neighbourhoods with "
            f"the kNN kernel; grouper={spec.grouper!r} cannot lower fused "
            f"(use grouper='knn' or fused_group='none')")
    prec = spec.stage_precision or (spec.precision,) * N_STAGES
    bad = [s + 1 for s in range(N_STAGES) if prec[s] == "int8"]
    if bad:
        raise ValueError(
            f"RPA011: fused_group={fused!r} requires fp32 transfer layers; "
            f"stages {bad} resolve to int8 (set precision / "
            f"stage_precision to 'fp32' there, or fused_group='none')")
    if not spec.fuse:
        raise ValueError(
            f"RPA012: fused_group={fused!r} consumes BN-folded (w, b) "
            f"transfer layers; set fuse=True (or fused_group='none')")


# ------------------------------------------------- paper variants -------

def elite_spec(n_classes: int = 40, **overrides) -> PipelineSpec:
    """PointMLP-Elite: FPS, learnable affine, fp32, 1024 points."""
    fields = dict(name="pointmlp-elite", n_classes=n_classes)
    fields.update(overrides)
    return PipelineSpec(**fields)


def m2_spec(n_classes: int = 40, **overrides) -> PipelineSpec:
    """M-2 of Table 1: 512 points, URS, alpha/beta pruned, BN fused."""
    fields = dict(name="pointmlp-m2", n_points=512, sampler="urs",
                  affine_mode="norm", n_classes=n_classes)
    fields.update(overrides)
    return PipelineSpec(**fields)


def lite_spec(n_classes: int = 40, **overrides) -> PipelineSpec:
    """PointMLP-Lite: M-2 topology + 8/8 int8 deployment."""
    fields = dict(name="pointmlp-lite", precision="int8", w_bits=8,
                  a_bits=8)
    fields.update(overrides)
    return m2_spec(n_classes).replace(**fields)


def compression_ladder_specs(n_classes: int = 40) -> List[PipelineSpec]:
    """The Table 1 ladder as specs: Elite, M-1 .. M-4, Lite, lifted from
    ``repro_torch.core.compress.compression_ladder`` (imported here, when
    called: ``core.compress`` sits above the models in the import graph)."""
    from repro_torch.core.compress import compression_ladder
    return [PipelineSpec.from_model_config(cfg)
            for cfg in compression_ladder(n_classes)]
