"""Roofline-guided spec autotuner and ``BENCH_<rev>.json`` artifacts.

    from repro_torch.tune import tune
    doc = tune(lite_spec(40), device="cpu")        # artifact dict

Submodules: ``search`` (estimate -> rank -> measure), ``frontier``
(deterministic Pareto selection) and ``artifact`` (the ``repro.bench/v1``
writer, reader and validator, shared with ``repro.tune`` and
``scripts/bench_diff.py``); ``kernels`` (the tile sweep on the card,
``plan_tuning`` and ``tuning_candidates``) is imported as
``repro_torch.tune.kernels``.
"""
from __future__ import annotations

from repro_torch.tune.artifact import (SCHEMA, ArtifactError, new_artifact,
                                       new_row, read_artifact, resolve_rev,
                                       validate_artifact, write_artifact)
from repro_torch.tune.frontier import (dominates, mark_frontier,
                                       pareto_frontier)
from repro_torch.tune.search import (ANCHOR_NAME, Candidate, anchor_spec,
                                     quick_space, tune)

__all__ = [
    "ANCHOR_NAME", "ArtifactError", "Candidate", "SCHEMA", "anchor_spec",
    "dominates", "mark_frontier", "new_artifact", "new_row",
    "pareto_frontier", "quick_space", "read_artifact", "resolve_rev",
    "tune", "validate_artifact", "write_artifact",
]
