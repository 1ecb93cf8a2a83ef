"""Roofline-guided spec autotuner (the paper's design-space loop, closed).

The twin of ``repro.tune.search``.  ``tune(base_spec)`` walks the design
space as HLS4PC's Table 1 and Fig. 4 do: every candidate spec is first
scored statically, by lowering it to a :class:`~repro_torch.api.plan.
StagePlan` and pushing its ``cost_breakdown`` through a
:mod:`repro_torch.roofline` hardware model; then only the top-K estimated
candidates, and the fp32-ref anchor always, are measured through
``PointCloudEngine`` on the device, for samples/s and an error against
the anchor's logits.  The estimates, the measurements and the measured
Pareto frontier land in one ``repro.bench/v1`` artifact
(:mod:`repro_torch.tune.artifact`).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import roofline
from repro_torch.api import plan as stage_plan
from repro_torch.kernels.tuning import DEFAULT_TUNING
from repro_torch.tune import artifact as art
from repro_torch.tune.frontier import mark_frontier
from repro_torch.tune.kernels import tuning_candidates

ANCHOR_NAME = "fp32-ref"


@dataclasses.dataclass
class Candidate:
    """One point of the search space, scored and (maybe) measured."""
    spec: Any
    fingerprint: str
    label: str
    estimate: Optional[roofline.PlanEstimate] = None
    est_error: Optional[str] = None       # why it could not be estimated
    measured_sps: Optional[float] = None
    err_vs_fp32: Optional[float] = None
    measure_error: Optional[str] = None
    anchor: bool = False

    @property
    def est_time(self) -> float:
        return self.estimate.total_s if self.estimate else float("inf")


def quick_space(base) -> List[Any]:
    """The quick search space around ``base``: the precision ladder x
    {``ref``, ``cuda``} x {unfused, fused group->transfer} x {1, N}-way
    sharding (N = min(8, CUDA devices), only on a host with two or more)
    x the static tile candidates (``tune.kernels.tuning_candidates(
    quick=True)``: the defaults and the card's small tiles), as
    ``repro.tune.quick_space``."""
    n_dev = torch.cuda.device_count()
    return stage_plan.enumerate_plan_space(
        base,
        stage_backends=(("ref",) * 4, ("cuda",) * 4),
        fused_groups=("none", "grouped_transfer"),
        data_shards=(1,) if n_dev < 2 else (1, min(8, n_dev)),
        kernel_tunings=tuning_candidates(quick=True))


def anchor_spec(base):
    """The fp32 reference deployment every run measures: uniform fp32,
    the ``ref`` backend, unfused, unsharded (the error's zero point)."""
    return base.replace(precision="fp32", stage_precision=None,
                        stage_backend=None, backend="ref",
                        fused_group="none", data_shards=1)


def _static_prune(cand: Candidate) -> bool:
    """Analyzer gate before estimation: a candidate whose spec has
    lowering-scope error findings gets a coded ``est_error`` row (e.g.
    ``RPA011: ...``) and is never lowered."""
    from repro_torch.analysis import ERROR, analyze_spec
    errs = [f for f in analyze_spec(cand.spec, scopes=("lowering",))
            if f.severity == ERROR]
    if errs:
        cand.est_error = "; ".join(f.render() for f in errs)
        return True
    return False


def _estimate(cand: Candidate, hw: roofline.HardwareModel,
              batch: int) -> None:
    """Lower and estimate at a dispatch of ``batch`` clouds.  A spec the
    port does not run yet records its ``NotImplementedError`` (naming its
    ROADMAP.md item) as the row's ``est_error``, as an invalid one (a
    tile its kernel lacks among them) records its ``ValueError``."""
    try:
        cfg = cand.spec.to_model_config()
        with warnings.catch_warnings():
            # Warning findings are the search's normal noise.
            warnings.simplefilter("ignore")
            plan = stage_plan.lower(cand.spec, cfg)
        cand.estimate = roofline.estimate_plan(
            plan, cfg, hw, data_shards=cand.spec.data_shards, batch=batch)
    except (ValueError, KeyError, NotImplementedError) as e:
        cand.est_error = f"{type(e).__name__}: {e}"


def _measure(cand: Candidate, params, pts, *, max_batch: int, seed: int,
             iters: int, anchor_logits, device):
    """Samples/s and the mean |logit - anchor logit| of one candidate
    through ``PointCloudEngine``; returns the anchor's logits (the anchor
    is measured first)."""
    from repro_torch.serve.pointcloud import PointCloudEngine
    try:
        eng = PointCloudEngine(params, cand.spec, max_batch=max_batch,
                               seed=seed, device=device)
        eng.warmup()
        logits = eng.classify(pts).cpu()
        if anchor_logits is None:
            anchor_logits = logits
        cand.err_vs_fp32 = float((logits - anchor_logits).abs().mean())
        eng.stats.reset()
        for _ in range(iters):
            eng.classify(pts)
        cand.measured_sps = float(eng.stats.samples_per_s)
    except Exception as e:  # noqa: BLE001 — a candidate that cannot run is a row
        cand.measure_error = f"{type(e).__name__}: {e}"
    return anchor_logits


def _row(cand: Candidate) -> Dict[str, Any]:
    spec = cand.spec
    kt = spec.kernel_tuning or DEFAULT_TUNING
    spec_fields = {
        "sampler": spec.sampler, "grouper": spec.grouper,
        "backend": spec.backend, "precision": spec.precision,
        "stage_precision": list(spec.stage_precision or ()),
        "stage_backend": list(spec.stage_backend or ()),
        "fused_group": spec.fused_group, "data_shards": spec.data_shards,
        "n_points": spec.n_points,
        "kernel_tuning": {"fused_linear": list(kt.fused_linear),
                          "int8_matmul": list(kt.int8_matmul),
                          "grouped_transfer": kt.grouped_transfer,
                          "fps": kt.fps, "knn": kt.knn}}
    est = cand.estimate
    return art.new_row(
        cand.label, fingerprint=cand.fingerprint,
        derived=cand.est_error or cand.measure_error,
        estimated_sps=(est.sps if est else None),
        measured_sps=cand.measured_sps, err_vs_fp32=cand.err_vs_fp32,
        anchor=cand.anchor, spec=spec_fields,
        stages=(est.to_rows() if est and (cand.measured_sps is not None
                                          or cand.anchor) else None))


def tune(base_spec, params=None, *, space: Optional[List] = None,
         top_k: int = 3, hw: Optional[roofline.HardwareModel] = None,
         max_batch: int = 8, n_requests: Optional[int] = None,
         measure_iters: int = 1, seed: int = 0, rev: Optional[str] = None,
         device=None) -> Dict[str, Any]:
    """Run the roofline-guided search; returns a validated artifact.

    Args:
      base_spec: what every candidate shares (serving semantics are
        applied: the engines' batch contract).
      params: a parameter tree for ``base_spec``'s topology; when None,
        ``pointmlp_init`` from ``torch.Generator().manual_seed(seed)``
        (throughput and the error proxy need no trained weights).
      space: candidate specs; :func:`quick_space` around the base when
        None.
      top_k: how many of the estimated-fastest candidates are measured,
        besides the anchor.
      hw: the estimate's hardware model; None means ``H100_SXM`` on
        ``cuda`` and ``CPU_HOST`` on the CPU.
      max_batch: the one dispatch shape every measured candidate uses
        (and the estimate's tile waste assumes).
      n_requests: the measured queue's length (``2 * max_batch`` when
        None): standard-normal ``[n_requests, n_points, 3]`` float32
        clouds from ``np.random.default_rng(seed + 1)``.
      rev: the artifact's ``rev``; ``$BENCH_REV`` or git when None.
      device: where candidates are measured; None means ``cuda``
        (raising without a GPU), ``"cpu"`` runs the plain versions.
    """
    from repro_torch.api.build import resolve_device
    from repro_torch.models.pointmlp import pointmlp_init

    dev = resolve_device(device)
    if hw is None:
        hw = roofline.H100_SXM if dev.type == "cuda" else roofline.CPU_HOST
    base = base_spec.serving()
    anchor = anchor_spec(base)
    anchor_fp = stage_plan.spec_fingerprint(anchor)

    cands: List[Candidate] = [Candidate(
        spec=anchor, fingerprint=anchor_fp, label=ANCHOR_NAME,
        anchor=True)]
    for spec in (space if space is not None else quick_space(base)):
        fp = stage_plan.spec_fingerprint(spec)
        if fp == anchor_fp:               # the anchor already covers it
            continue
        cands.append(Candidate(spec=spec, fingerprint=fp,
                               label=stage_plan.spec_label(spec)))

    for cand in cands:
        if not _static_prune(cand):
            _estimate(cand, hw, max_batch)

    # The anchor, then the top-K estimated-fastest viable candidates in a
    # deterministic order (estimated time, then fingerprint).
    ranked = sorted((c for c in cands if not c.anchor and c.estimate),
                    key=lambda c: (c.est_time, c.fingerprint))
    to_measure = [cands[0]] + ranked[:max(top_k, 0)]

    if params is None:
        params = pointmlp_init(base.to_model_config(),
                               torch.Generator().manual_seed(seed))
    n_req = n_requests if n_requests is not None else 2 * max_batch
    pts = np.random.default_rng(seed + 1).standard_normal(
        (n_req, base.n_points, 3)).astype(np.float32)
    anchor_logits = None
    for cand in to_measure:
        anchor_logits = _measure(cand, params, pts, max_batch=max_batch,
                                 seed=seed, iters=measure_iters,
                                 anchor_logits=anchor_logits, device=dev)

    rows = [_row(c) for c in cands]
    mark_frontier(rows)
    # The anchor is the frontier's reference point by definition: a
    # bitwise-equal but faster twin may tie it at err 0, never evict it.
    if rows[0]["measured_sps"] is not None:
        rows[0]["frontier"] = True
    return art.new_artifact(rows, rev=rev, source="repro_torch.tune",
                            hw=dataclasses.asdict(hw))
