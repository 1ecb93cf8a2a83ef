"""``repro_torch.analysis``: static plan verification before build.

The twin of ``repro.analysis``: every invariant of the port's pipeline
API is a named ``RPAxxx`` code (:data:`CODES`, the JAX table), produced
by a registered spec pass (``passes``) or a registry contract check
(``contracts``) and enforced through one raise/warn path that
``spec.validate()``, ``plan.lower()`` and ``FleetSpec.validate()`` share.

    python -m repro_torch.analysis --all-variants

``findings`` is standard library only; ``passes`` pulls in
``repro_torch.api``, ``contracts`` runs registry entries on CPU tensors
and ``trace`` (the trace pass: each lowered stage callable run once
under an op recorder and held to RPA201-204, RPA209) runs them on CPU or
CUDA tensors, so all three load when first called.
"""
from repro_torch.analysis.findings import (  # noqa: F401 — the public surface
    CODES,
    ERROR,
    INFO,
    WARNING,
    AnalysisWarning,
    Finding,
    dedupe,
    enforce,
    error_codes,
    finding,
    format_findings,
    has_errors,
    warn_finding,
)


def analyze_spec(spec, scopes=None):
    """See :func:`repro_torch.analysis.passes.analyze_spec`."""
    from repro_torch.analysis.passes import analyze_spec as _impl
    return _impl(spec, scopes=scopes)


def analyze_fleet_spec(fleet_spec):
    """See :func:`repro_torch.analysis.passes.analyze_fleet_spec`."""
    from repro_torch.analysis.passes import analyze_fleet_spec as _impl
    return _impl(fleet_spec)


def enforce_spec(spec, scopes=None, stacklevel: int = 3):
    """See :func:`repro_torch.analysis.passes.enforce_spec`."""
    from repro_torch.analysis.passes import enforce_spec as _impl
    return _impl(spec, scopes=scopes, stacklevel=stacklevel + 1)


def analyze_plan_trace(spec, cfg=None, plan=None, device="cpu",
                       traces=None):
    """See :func:`repro_torch.analysis.trace.analyze_plan_trace`."""
    from repro_torch.analysis.trace import analyze_plan_trace as _impl
    return _impl(spec, cfg=cfg, plan=plan, device=device, traces=traces)


def check_registry_contracts():
    """See :func:`repro_torch.analysis.contracts.check_registry_contracts`."""
    from repro_torch.analysis.contracts import check_registry_contracts as _impl
    return _impl()


__all__ = [
    "CODES", "ERROR", "WARNING", "INFO", "AnalysisWarning", "Finding",
    "dedupe", "enforce", "error_codes", "finding", "format_findings",
    "has_errors", "warn_finding", "analyze_spec", "analyze_fleet_spec",
    "enforce_spec", "analyze_plan_trace", "check_registry_contracts",
]
