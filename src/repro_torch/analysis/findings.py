"""Typed findings: the one result currency of the port's static analyzer.

A copy of ``repro.analysis.findings``.  Every invariant the port's
pipeline API enforces (registry keys, the fused lowering's
preconditions, the stream-cache contract, sharding's per-sample-norm
requirement, the registry entries' determinism) is a :class:`Finding`
with a stable ``RPAxxx`` code, whether it surfaces from
``spec.validate()``, ``plan.lower()``, ``build()``, the ``python -m
repro_torch.analysis`` CLI or a test asserting an exact code.
:func:`enforce` is the one raise/warn path: error findings raise their
recorded exception type with a code-prefixed message, warning findings
emit :class:`AnalysisWarning` (a ``UserWarning`` the repo's pytest
settings turn into an error by its ``RPA\\d\\d\\d`` prefix).

:data:`CODES` is JAX's table entry for entry, so a code means the same
thing in both packages.  The RPA2xx codes have no producer here: they
come from ``repro.analysis.trace``, which reads jaxprs, and the port
runs none.  RPA301 and RPA302 come from running each registry entry
twice on small CPU tensors (``repro_torch.analysis.contracts``), not
from a trace.

Standard library only, so every layer of the port can import it.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Iterable, List, Sequence, Tuple, Type

ERROR = "error"
WARNING = "warning"
INFO = "info"

#: The documented code table: code -> (severity, one-line title).
#: Codes are append-only; a retired check keeps its number reserved.
CODES = {
    # --- spec/lowering invariants (ported ad-hoc raise sites) --------
    "RPA001": (ERROR, "unknown sampler registry key"),
    "RPA002": (ERROR, "unknown grouper registry key"),
    "RPA003": (ERROR, "unknown backend registry key"),
    "RPA004": (ERROR, "unknown fused-op registry key"),
    "RPA005": (ERROR, "unknown batch-policy registry key"),
    "RPA006": (ERROR, "unknown router registry key"),
    "RPA010": (ERROR, "fused_group requires the knn grouper"),
    "RPA011": (ERROR, "fused_group requires fp32 transfer stages"),
    "RPA012": (ERROR, "fused_group requires BN fusion (spec.fuse)"),
    "RPA013": (ERROR, "stream=True is incompatible with fused_group"),
    "RPA014": (ERROR, "stream grouper lacks the neighbor_index/"
                      "group_with_idx split"),
    "RPA015": (ERROR, "stream sampler does not declare advances_state"),
    "RPA020": (ERROR, "data_shards > 1 requires per_sample_norm"),
    "RPA030": (ERROR, "stream session over a non-streaming pipeline"),
    # --- soft misconfigurations (escalated in-tree via the code
    #     prefix; plain warnings for external callers) ----------------
    "RPA101": (WARNING, "int8 stage on a pallas backend falls back to "
                        "the reference int8 matmul (retired: int8 x "
                        "pallas now lowers to the int8 Pallas matmul)"),
    "RPA102": (WARNING, "policy ignores the spec's dispatch_ms "
                        "reservation"),
    "RPA103": (WARNING, "deadline-style policy collapses into "
                        "dispatch-on-arrival"),
    "RPA104": (WARNING, "stage arithmetic intensity far off its "
                        "siblings (roofline anomaly)"),
    # --- jaxpr-level trace findings (repro.analysis.trace) -----------
    "RPA201": (ERROR, "float64 value in a traced stage jaxpr"),
    "RPA202": (ERROR, "silent int8->float upcast (dequant without the "
                      "scale multiply)"),
    "RPA203": (ERROR, "host-callback/nondeterministic primitive inside "
                      "a shard_map-dispatched region"),
    "RPA204": (ERROR, "cross-shard collective over the P('data') axis"),
    "RPA209": (ERROR, "stage callable failed to trace"),
    # --- registry determinism contracts (repro.analysis.contracts) ---
    "RPA301": (ERROR, "sampler advances_state contradicts its traced "
                      "jaxpr"),
    "RPA302": (ERROR, "registry entry re-traces to a different jaxpr "
                      "(nondeterministic trace)"),
    "RPA303": (ERROR, "router/policy violates the pure-function "
                      "contract"),
    # --- analyzer bookkeeping ----------------------------------------
    "RPA298": (ERROR, "analyzer-clean spec failed to lower (pass/"
                      "lowering drift)"),
    "RPA900": (INFO, "module excluded from the analyzer sweep "
                     "(tracked RPA-skip list)"),
}


class AnalysisWarning(UserWarning):
    """Warning category for warning-severity findings.  A subclass of
    ``UserWarning`` so existing ``pytest.warns(UserWarning, ...)``
    call sites keep catching the routed messages."""


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer result: a coded, located, typed diagnostic.

    ``op`` names the site — a spec field (``"spec.fused_group"``), a
    plan op path (``"stages.2.transfer"``), a registry entry
    (``"sampler:urs"``) — whatever lets a reader jump to the problem.
    ``exc_type`` is what :func:`enforce` raises for an error finding
    (``repro_torch.api.spec.UnknownKeyError``, a ``KeyError`` and a
    ``ValueError``, for registry-key misses; ``ValueError`` otherwise).
    """
    code: str
    severity: str
    op: str
    message: str
    exc_type: Type[Exception] = dataclasses.field(default=ValueError,
                                                  compare=False)

    def __post_init__(self):
        if self.code not in CODES:
            raise ValueError(f"unknown finding code {self.code!r}; "
                             f"add it to repro_torch.analysis.findings.CODES")
        if self.severity != CODES[self.code][0]:
            raise ValueError(
                f"finding {self.code} must have severity "
                f"{CODES[self.code][0]!r}, got {self.severity!r}")

    def render(self) -> str:
        return f"{self.code}: {self.message}"

    def __str__(self) -> str:
        return f"[{self.severity}] {self.code} @ {self.op}: {self.message}"


def finding(code: str, op: str, message: str,
            exc_type: Type[Exception] = ValueError) -> Finding:
    """Build a :class:`Finding`, deriving severity from :data:`CODES`.
    An unlisted code is a ``ValueError`` (``Finding.__post_init__``)."""
    severity = CODES[code][0] if code in CODES else ERROR
    return Finding(code=code, severity=severity, op=op,
                   message=message, exc_type=exc_type)


def has_errors(findings: Iterable[Finding]) -> bool:
    return any(f.severity == ERROR for f in findings)


def error_codes(findings: Iterable[Finding]) -> Tuple[str, ...]:
    """The distinct error codes present, sorted — the shape tests and
    the CLI summarize with."""
    return tuple(sorted({f.code for f in findings if f.severity == ERROR}))


def warn_finding(f: Finding, stacklevel: int = 3) -> None:
    """Emit one warning-severity finding as an :class:`AnalysisWarning`
    whose message leads with the stable code (the pyproject
    ``filterwarnings`` escalation keys on ``RPA\\d\\d\\d``)."""
    warnings.warn(f.render(), AnalysisWarning, stacklevel=stacklevel)


def enforce(findings: Sequence[Finding], stacklevel: int = 3) -> None:
    """The one raise/warn path: emit every warning finding, then raise
    the first error finding with its recorded exception type and a
    code-prefixed message.  Info findings are reporting-only."""
    for f in findings:
        if f.severity == WARNING:
            warn_finding(f, stacklevel=stacklevel + 1)
    for f in findings:
        if f.severity == ERROR:
            raise f.exc_type(f.render())


def format_findings(findings: Sequence[Finding]) -> str:
    """Multi-line rendering for the CLI report."""
    return "\n".join(str(f) for f in findings)


def dedupe(findings: Iterable[Finding]) -> List[Finding]:
    """Drop repeated (code, op) pairs, keeping first occurrence order."""
    seen = set()
    out: List[Finding] = []
    for f in findings:
        key = (f.code, f.op)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out
