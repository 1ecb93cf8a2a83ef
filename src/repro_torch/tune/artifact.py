"""Schema-versioned ``BENCH_<rev>.json`` perf artifacts.

A copy of ``repro.tune.artifact`` with the same :data:`SCHEMA`, so
``repro.tune.read_artifact`` and ``scripts/bench_diff.py`` read an
artifact of the port's tuner and the other way round.  One artifact is a
dict::

    {"schema": "repro.bench/v1", "rev": "<git sha>", "source": "...",
     "hw": {...} | null, "rows": [<row>, ...]}

and one row is the shared record both the tuner and the ``--quick``
benchmark emit (so humans, ``scripts/bench_diff.py`` and the CI
regression gate all consume the same run):

    name            str   stable row id (the CI diff matches on it)
    fingerprint     str?  repro_torch.api.plan.spec_fingerprint of the spec
    us_per_call     num?  free-running time column of the CSV rows
    derived         str?  the CSV row's free-text payload
    estimated_sps   num?  static roofline estimate (repro_torch.roofline)
    measured_sps    num?  measured samples/sec (None = estimate-only)
    err_vs_fp32     num?  accuracy proxy vs the fp32-ref anchor
    shed_rate       num?  fleet rows: shed fraction of offered requests
    cache_hit_rate  num?  stream rows: temporal-cache hit fraction
    frontier        bool  row is on the measured Pareto frontier
    anchor          bool  row is the fp32-ref reference point
    spec            dict? searched spec fields (human provenance)
    stages          list? per-stage FLOPs/bytes rows (cost_breakdown)

Readers must call :func:`validate_artifact` (``read_artifact`` does) —
a wrong/old ``schema`` string or a malformed row raises
:class:`ArtifactError` with a message that says what to regenerate.
"""
from __future__ import annotations

import json
import math
import os
import pathlib
import subprocess
from typing import Any, Dict, List, Optional

SCHEMA = "repro.bench/v1"

_NUMERIC_KEYS = ("us_per_call", "estimated_sps", "measured_sps",
                 "err_vs_fp32", "shed_rate", "cache_hit_rate")
_BOOL_KEYS = ("frontier", "anchor")


class ArtifactError(ValueError):
    """A BENCH artifact that cannot be trusted: wrong schema version,
    missing/mistyped fields, non-finite metrics."""


def new_row(name: str, *, fingerprint: Optional[str] = None,
            us_per_call: Optional[float] = None,
            derived: Optional[str] = None,
            estimated_sps: Optional[float] = None,
            measured_sps: Optional[float] = None,
            err_vs_fp32: Optional[float] = None,
            shed_rate: Optional[float] = None,
            cache_hit_rate: Optional[float] = None,
            frontier: bool = False, anchor: bool = False,
            spec: Optional[Dict[str, Any]] = None,
            stages: Optional[List[Dict[str, Any]]] = None) -> Dict[str, Any]:
    """One shared-schema row (plain dict — JSON-ready)."""
    return {"name": name, "fingerprint": fingerprint,
            "us_per_call": us_per_call, "derived": derived,
            "estimated_sps": estimated_sps, "measured_sps": measured_sps,
            "err_vs_fp32": err_vs_fp32, "shed_rate": shed_rate,
            "cache_hit_rate": cache_hit_rate,
            "frontier": bool(frontier), "anchor": bool(anchor),
            "spec": spec, "stages": stages}


def resolve_rev() -> str:
    """The revision tag for the artifact filename / ``rev`` field:
    ``$BENCH_REV`` if set (CI passes the PR head sha), else the short
    git sha, else ``"local"``."""
    rev = os.environ.get("BENCH_REV")
    if rev:
        return rev
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
            cwd=pathlib.Path(__file__).resolve().parent)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return "local"


def new_artifact(rows: List[Dict[str, Any]], *, rev: Optional[str] = None,
                 source: str = "repro.tune",
                 hw: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Assemble + validate a full artifact doc."""
    return validate_artifact({
        "schema": SCHEMA,
        "rev": rev if rev is not None else resolve_rev(),
        "source": source, "hw": hw, "rows": list(rows)})


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ArtifactError(msg)


def validate_artifact(doc: Any) -> Dict[str, Any]:
    """Validate an artifact doc against the v1 schema; returns it.

    Raises :class:`ArtifactError` naming the exact defect — an old or
    foreign ``schema`` string is the first check, so stale baselines
    from before a schema bump fail with "regenerate" instead of a
    confusing key error downstream.
    """
    _check(isinstance(doc, dict), f"BENCH artifact must be a JSON object, "
           f"got {type(doc).__name__}")
    got = doc.get("schema")
    _check(got == SCHEMA,
           f"BENCH artifact schema is {got!r}, this repro_torch reads "
           f"{SCHEMA!r} — regenerate it with "
           f"`repro_torch.tune.write_artifact(path, "
           f"repro_torch.tune.tune(spec))`")
    _check(isinstance(doc.get("rev"), str) and doc["rev"],
           "BENCH artifact is missing its 'rev' string")
    rows = doc.get("rows")
    _check(isinstance(rows, list),
           f"BENCH artifact 'rows' must be a list, "
           f"got {type(rows).__name__}")
    seen = set()
    for i, row in enumerate(rows):
        where = f"rows[{i}]"
        _check(isinstance(row, dict), f"{where} must be an object")
        name = row.get("name")
        _check(isinstance(name, str) and bool(name),
               f"{where} needs a non-empty 'name' string")
        _check(name not in seen, f"duplicate row name {name!r}")
        seen.add(name)
        for k in _NUMERIC_KEYS:
            v = row.get(k)
            if v is None:
                continue
            _check(isinstance(v, (int, float)) and not isinstance(v, bool)
                   and math.isfinite(v),
                   f"{where}.{k} must be a finite number or null, "
                   f"got {v!r}")
        for k in _BOOL_KEYS:
            v = row.get(k, False)
            _check(isinstance(v, bool), f"{where}.{k} must be a bool, "
                   f"got {v!r}")
        stages = row.get("stages")
        if stages is not None:
            _check(isinstance(stages, list) and
                   all(isinstance(s, dict) for s in stages),
                   f"{where}.stages must be a list of objects")
    return doc


def write_artifact(path, doc: Dict[str, Any]) -> pathlib.Path:
    """Validate and write one artifact (pretty-printed, trailing \\n)."""
    path = pathlib.Path(path)
    validate_artifact(doc)
    path.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")
    return path


def read_artifact(path) -> Dict[str, Any]:
    """Read + validate one artifact; JSON/SCHEMA errors both surface as
    :class:`ArtifactError` naming the file."""
    path = pathlib.Path(path)
    try:
        doc = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise ArtifactError(f"cannot read BENCH artifact {path}: {e}") \
            from e
    try:
        return validate_artifact(doc)
    except ArtifactError as e:
        raise ArtifactError(f"{path}: {e}") from None
