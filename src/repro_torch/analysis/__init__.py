"""``repro_torch.analysis``: static plan verification before build.

The twin of ``repro.analysis``: every invariant of the port's pipeline
API is a named ``RPAxxx`` code (:data:`CODES`, the JAX table), produced
by a registered spec pass (``passes``) or a registry contract check
(``contracts``) and enforced through one raise/warn path that
``spec.validate()``, ``plan.lower()`` and ``FleetSpec.validate()`` share.

    python -m repro_torch.analysis --all-variants

``findings`` is standard library only; ``passes`` pulls in
``repro_torch.api`` and ``contracts`` runs registry entries on CPU
tensors, so both load when first called.  JAX's trace pass reads jaxprs
and has no counterpart here.
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


def check_registry_contracts():
    """See :func:`repro_torch.analysis.contracts.check_registry_contracts`."""
    from repro_torch.analysis.contracts import check_registry_contracts as _impl
    return _impl()


__all__ = [
    "CODES", "ERROR", "WARNING", "INFO", "AnalysisWarning", "Finding",
    "dedupe", "enforce", "error_codes", "finding", "format_findings",
    "has_errors", "warn_finding", "analyze_spec", "analyze_fleet_spec",
    "enforce_spec", "check_registry_contracts",
]
