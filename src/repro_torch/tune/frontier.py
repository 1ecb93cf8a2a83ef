"""Pareto-frontier selection over measured (err, throughput) rows.

A copy of ``repro.tune.frontier``.

The paper's Fig. 4 shape: every measured candidate is a point in
(accuracy-proxy error, samples/sec) space and the frontier is the set
no other point dominates — lower-or-equal error *and*
higher-or-equal throughput with at least one strict.  Selection is a
pure order-independent function of the row values (dominance doesn't
care how the list was shuffled) and the returned order is canonical,
so the tuner's artifact is deterministic under a fixed seed.
"""
from __future__ import annotations

from typing import Any, Dict, List

COST_KEY = "err_vs_fp32"       # minimize
GAIN_KEY = "measured_sps"      # maximize


def _comparable(row: Dict[str, Any]) -> bool:
    return (isinstance(row.get(COST_KEY), (int, float))
            and isinstance(row.get(GAIN_KEY), (int, float)))


def dominates(a: Dict[str, Any], b: Dict[str, Any]) -> bool:
    """True iff ``a`` Pareto-dominates ``b`` (never for exact ties)."""
    le = a[COST_KEY] <= b[COST_KEY] and a[GAIN_KEY] >= b[GAIN_KEY]
    lt = a[COST_KEY] < b[COST_KEY] or a[GAIN_KEY] > b[GAIN_KEY]
    return le and lt


def pareto_frontier(rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The non-dominated subset of ``rows``, in canonical order
    (ascending error, descending throughput, then name).

    Rows missing either metric (estimate-only candidates, unavailable
    backends) are excluded — they are not measured points.  Exact
    duplicates both survive (neither strictly dominates), so the
    frontier of a self-comparison is stable.
    """
    pts = [r for r in rows if _comparable(r)]
    front = [r for r in pts
             if not any(dominates(q, r) for q in pts if q is not r)]
    return sorted(front, key=lambda r: (r[COST_KEY], -r[GAIN_KEY],
                                        str(r.get("name", ""))))


def mark_frontier(rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Set each row's ``"frontier"`` flag in place; returns ``rows``."""
    front = {id(r) for r in pareto_frontier(rows)}
    for r in rows:
        r["frontier"] = id(r) in front
    return rows
