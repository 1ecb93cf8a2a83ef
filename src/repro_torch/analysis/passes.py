"""Spec-level analysis passes: the registry of the port's static plan checks.

The twin of ``repro.analysis.passes``, pass for pass and scope for
scope.  Each pass is a function ``(spec) -> List[Finding]`` registered
with :func:`register_pass` under a name and a *scope*:

  ``lowering``   what ``plan.lower(spec, cfg)`` needs (registry keys,
                 the fused group's preconditions, the stream-cache
                 contract).  Enforced by ``lower()``; ``enumerate_plan_
                 space`` and ``repro_torch.tune`` prune the search with it.
  ``serving``    what the engines need (the batch-policy key).
  ``placement``  what a split dispatch needs (per-sample normalization).
  ``perf``       advisory roofline findings (a stage whose arithmetic
                 intensity sits far off its siblings); never enforced by
                 ``lower()`` and never a reason to prune.

``spec.validate()`` enforces every scope, :func:`analyze_spec` returns
the findings without raising.  Fleet specs go through
:func:`analyze_fleet_spec`, which adds the router key (RPA006).

The messages are the port's own: each names the spec field to change.
Registry-key findings raise :class:`~repro_torch.api.spec.
UnknownKeyError` (a ``KeyError``, as JAX's, and a ``ValueError``, like
the port's other spec rules).  A plugin check is one decorator away::

    from repro_torch.analysis.passes import register_pass

    @register_pass("my-invariant", scope="lowering")
    def my_invariant(spec): return [...]
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis import findings as F
from repro_torch.analysis.findings import Finding, finding
from repro_torch.api import registry
from repro_torch.api.spec import N_STAGES, UnknownKeyError

SCOPES = ("lowering", "serving", "placement", "perf")

PASSES = registry.Registry("analysis-pass")


def register_pass(name: str, *, scope: str
                  ) -> Callable[[Callable], Callable]:
    """Register a spec pass under ``name`` with the given scope."""
    if scope not in SCOPES:
        raise ValueError(f"pass scope must be one of {SCOPES}, "
                         f"got {scope!r}")

    def deco(fn: Callable) -> Callable:
        fn.scope = scope
        return PASSES.register(name)(fn)
    return deco


def _skip_modules() -> Dict[str, str]:
    """The LM config modules outside the point-cloud pipeline space: the
    ten archs of ``repro_torch.configs``, each with the model module that
    serves it."""
    from repro_torch import configs
    served_by = {"audio": "models/encdec.py", "ssm": "models/xlstm.py",
                 "hybrid": "models/hymba.py"}
    out = {}
    for arch, mod in configs._ARCH_MODULES.items():
        family = configs.get_config(arch).family
        out[f"repro_torch.configs.{mod}"] = (
            f"LM config ({family}, served by "
            f"{served_by.get(family, 'models/transformer.py')})")
    return out


#: Tracked RPA-skip list: LM config modules the analyzer sweep excludes;
#: the CLI reports each as an RPA900 info finding so the list stays seen.
RPA_SKIP_MODULES = _skip_modules()


def skip_list_findings() -> List[Finding]:
    """The RPA900 info findings for every tracked skip-list module."""
    return [finding("RPA900", mod, f"excluded from the analyzer sweep: "
                                   f"{why}")
            for mod, why in sorted(RPA_SKIP_MODULES.items())]


def _key_finding(code: str, reg, name: str, op: str) -> List[Finding]:
    """RPA00x for an unresolvable registry key: the registry's own message
    (it lists the registered names) and the field to set."""
    try:
        reg.get(name)
        return []
    except KeyError as e:
        field = op.split(".", 1)[1]
        return [finding(code, op, f"{e.args[0]} (set {field} to one of "
                                  f"them)", exc_type=UnknownKeyError)]


# ------------------------------------------------- lowering passes ------

@register_pass("registry-keys", scope="lowering")
def registry_keys(spec) -> List[Finding]:
    """RPA001-004: every component key a lowering resolves must exist."""
    out: List[Finding] = []
    out += _key_finding("RPA001", registry.SAMPLERS, spec.sampler,
                        "spec.sampler")
    out += _key_finding("RPA002", registry.GROUPERS, spec.grouper,
                        "spec.grouper")
    out += _key_finding("RPA003", registry.BACKENDS, spec.backend,
                        "spec.backend")
    for s, b in enumerate(spec.stage_backend or ()):
        out += _key_finding("RPA003", registry.BACKENDS, b,
                            f"spec.stage_backend[{s}]")
    if spec.fused_group != "none":
        out += _key_finding("RPA004", registry.FUSED_OPS,
                            spec.fused_group, "spec.fused_group")
    return out


@register_pass("fused-preconditions", scope="lowering")
def fused_preconditions(spec) -> List[Finding]:
    """RPA010-012: what the fused group->transfer lowering requires."""
    fused = spec.fused_group
    if fused == "none" or fused not in registry.FUSED_OPS:
        return []                    # RPA004 already covers unknown keys
    out: List[Finding] = []
    if spec.grouper != "knn":
        out.append(finding(
            "RPA010", "spec.grouper",
            f"fused_group={fused!r} builds its neighbourhoods with the kNN "
            f"kernel; grouper={spec.grouper!r} cannot lower fused (use "
            f"grouper='knn' or fused_group='none')"))
    prec = spec.stage_precision or (spec.precision,) * N_STAGES
    bad = [s + 1 for s in range(N_STAGES) if prec[s] == "int8"]
    if bad:
        out.append(finding(
            "RPA011", "spec.stage_precision",
            f"fused_group={fused!r} requires fp32 transfer layers; stages "
            f"{bad} resolve to int8 (set precision / stage_precision to "
            f"'fp32' there, or fused_group='none')"))
    if not spec.fuse:
        out.append(finding(
            "RPA012", "spec.fuse",
            f"fused_group={fused!r} consumes BN-folded (w, b) transfer "
            f"layers; set fuse=True (or fused_group='none')"))
    return out


@register_pass("stream-contract", scope="lowering")
def stream_contract(spec) -> List[Finding]:
    """RPA013-015: the stream-cache lowering contract."""
    if not spec.stream:
        return []
    out: List[Finding] = []
    if spec.fused_group != "none":
        out.append(finding(
            "RPA013", "spec.fused_group",
            f"stream=True is incompatible with fused_group="
            f"{spec.fused_group!r}: the fused group->transfer kernel has no "
            f"cache-aware lowering (set fused_group='none', or "
            f"stream=False)"))
    if spec.grouper in registry.GROUPERS:
        grouper = registry.GROUPERS.get(spec.grouper)
        if (getattr(grouper, "neighbor_index", None) is None
                or getattr(grouper, "group_with_idx", None) is None):
            out.append(finding(
                "RPA014", "spec.grouper",
                f"stream=True needs a grouper exposing the neighbor_index/"
                f"group_with_idx split (stream-cache contract); grouper "
                f"{spec.grouper!r} does not (set grouper='knn', or "
                f"stream=False)"))
    if spec.sampler in registry.SAMPLERS:
        sampler = registry.SAMPLERS.get(spec.sampler)
        if getattr(sampler, "advances_state", None) is None:
            out.append(finding(
                "RPA015", "spec.sampler",
                f"stream=True needs a sampler declaring its advances_state "
                f"stream-cache semantics; sampler {spec.sampler!r} does not "
                f"(set sampler='fps' or 'urs', or stream=False)"))
    return out


# ------------------------------------------------- serving passes -------

@register_pass("policy-key", scope="serving")
def policy_key(spec) -> List[Finding]:
    """RPA005: the engines must be able to make the spec's batch policy."""
    # Deferred import: the policy registry sits above this package.
    from repro_torch.serve.policy import POLICIES
    return _key_finding("RPA005", POLICIES, spec.policy, "spec.policy")


# ------------------------------------------------- placement passes -----

@register_pass("sharding-per-sample-norm", scope="placement")
def sharding_per_sample_norm(spec) -> List[Finding]:
    """RPA020: a device-split batch must not compute batch statistics."""
    if spec.data_shards <= 1 or spec.per_sample_norm:
        return []
    return [finding(
        "RPA020", "spec.per_sample_norm",
        "data_shards > 1 requires per-sample normalization (set "
        "per_sample_norm=True, e.g. via spec.serving()): batch-statistic "
        "normalization couples lanes across the whole dispatch, so a "
        "device-split batch would compute shard-local statistics and "
        "change results")]


# ------------------------------------------------- perf passes ----------

#: A stage is flagged when its arithmetic intensity is more than this
#: factor off the sibling median (in log space, either direction): every
#: shipped variant sits within about 3.1x, a pathologically wide stage
#: (``stage_expansion=(1, 1, 1, 64)``) 16x or more off.
INTENSITY_ANOMALY_FACTOR = 8.0


def stage_intensities(spec) -> Dict[str, float]:
    """Per-stage estimated arithmetic intensity (FLOPs per device-memory
    byte) from the lowered plan's ``cost_breakdown``.  Raises what
    ``lower()`` raises for a spec it cannot lower."""
    from repro_torch.api import plan as stage_plan
    cfg = spec.to_model_config()
    plan = stage_plan.lower(spec, cfg)
    agg: Dict[str, Tuple[int, int]] = {}
    for r in plan.cost_breakdown(cfg):
        name = r["op"].split(".")[0]
        if not name.startswith("stage"):
            continue
        fl, by = agg.get(name, (0, 0))
        agg[name] = (fl + r["flops"], by + r["w_bytes"] + r["act_bytes"])
    return {name: fl / max(by, 1) for name, (fl, by) in agg.items()}


@register_pass("stage-intensity-anomaly", scope="perf")
def stage_intensity_anomaly(spec) -> List[Finding]:
    """RPA104 (warning): a stage whose estimated arithmetic intensity
    falls far off its siblings' median, which usually means a mis-sized
    expansion or depth knob.  Advisory only: never blocks a lowering."""
    try:
        intens = stage_intensities(spec)
    except Exception:  # noqa: BLE001 — unlowerable specs belong to other scopes
        return []
    if len(intens) < 3:
        return []          # no meaningful sibling median
    logs = sorted(math.log(max(v, 1e-12)) for v in intens.values())
    n = len(logs)
    med = (logs[n // 2] if n % 2
           else 0.5 * (logs[n // 2 - 1] + logs[n // 2]))
    cut = math.log(INTENSITY_ANOMALY_FACTOR)
    out: List[Finding] = []
    for name in sorted(intens):
        dev = math.log(max(intens[name], 1e-12)) - med
        if abs(dev) > cut:
            direction = "compute" if dev > 0 else "memory"
            out.append(finding(
                "RPA104", f"plan.{name}",
                f"{name} estimated arithmetic intensity "
                f"{intens[name]:.2f} FLOP/byte is {math.exp(abs(dev)):.0f}x "
                f"off the sibling median, disproportionately "
                f"{direction}-bound (check the stage's stage_expansion / "
                f"pre_blocks / pos_blocks, or raise analysis.passes."
                f"INTENSITY_ANOMALY_FACTOR)"))
    return out


# ------------------------------------------------- entry points ---------

def analyze_spec(spec, scopes: Optional[Sequence[str]] = None
                 ) -> List[Finding]:
    """Run every registered pass whose scope is in ``scopes`` (all when
    None) and return the findings, in pass-name order."""
    wanted = set(scopes) if scopes is not None else set(SCOPES)
    bad = wanted - set(SCOPES)
    if bad:
        raise ValueError(f"unknown pass scopes {sorted(bad)}; "
                         f"known scopes: {SCOPES}")
    out: List[Finding] = []
    for name in PASSES.names():
        fn = PASSES.get(name)
        if fn.scope in wanted:
            out.extend(fn(spec))
    return out


def analyze_fleet_spec(fleet_spec) -> List[Finding]:
    """Every pool pipeline through every scope, plus the router key
    (RPA006)."""
    out: List[Finding] = []
    for p in fleet_spec.pipelines:
        for f in analyze_spec(p):
            out.append(Finding(code=f.code, severity=f.severity,
                               op=f"pipeline[{p.name}].{f.op}",
                               message=f.message, exc_type=f.exc_type))
    # Deferred import: serve sits above this package.
    from repro_torch.serve.router import ROUTERS
    out += _key_finding("RPA006", ROUTERS, fleet_spec.router,
                        "fleet.router")
    return out


def enforce_spec(spec, scopes: Optional[Sequence[str]] = None,
                 stacklevel: int = 3) -> None:
    """:func:`analyze_spec`, then :func:`~repro_torch.analysis.findings.
    enforce`: the path ``validate()`` and ``lower()`` share."""
    F.enforce(analyze_spec(spec, scopes=scopes), stacklevel=stacklevel)


def pass_names() -> Tuple[str, ...]:
    return PASSES.names()
