"""Static roofline estimate of a compiled stage plan (the tuner's ranking).

The plan-scope half of ``repro.roofline``: score a
:class:`~repro_torch.api.plan.StagePlan` from its analytic
``cost_breakdown`` (per-op FLOPs, weight bytes, activation bytes) against
a :class:`HardwareModel`, with no device and no compiled program, so the
search can rank the whole spec space and spend measurement time on the
promising candidates.  Each op is compute- or memory-bound on its own;
the estimate sums the per-op bounds.  Like JAX's, it counts no kNN or
FPS work (``cost_breakdown`` has no row for them).

The HLO half of ``repro.roofline`` (``parse_collectives``,
``from_compiled``, ``Roofline``) reads XLA's output and is not ported.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Peak rates the per-op roofline terms divide by.

    ``peak_int8_ops`` prices ops whose region resolved to int8;
    ``dispatch_overhead_s`` is a fixed floor a sample (launches, host
    work) so that tiny plans do not estimate as free.
    """
    name: str
    peak_flops: float            # fp32 FLOP/s per device
    peak_int8_ops: float         # int8 OP/s per device
    hbm_bw: float                # device-memory bytes/s
    dispatch_overhead_s: float = 0.0


#: A rough single-socket CPU host (``repro.roofline.CPU_HOST``'s numbers):
#: its absolute times mean nothing, only the ranking of candidates is
#: read; the overhead keeps small specs from estimating as pure bandwidth.
CPU_HOST = HardwareModel("cpu_host", peak_flops=5e10, peak_int8_ops=1e11,
                         hbm_bw=2e10, dispatch_overhead_s=2e-4)

#: One NVIDIA H100 SXM (data sheet, dense, at the 700 W limit): HBM3 at
#: 3.35 TB/s, fp32 on the CUDA cores at 67 TFLOP/s (FFMA, no TF32: the
#: port's fp32 kernels run FFMA) and int8 tensor cores at 1979 TOP/s.
#: ``dispatch_overhead_s`` is a Lite dispatch's host time a sample, as
#: ``chip_smoke.py``'s ``lite`` phase measured it on an NVIDIA H100 80GB
#: HBM3 at 700.00 W: ``serve_s`` a dispatch (0.24928 s over 15) less its
#: 3.5745 device ms, over the dispatch's 32 lanes.
H100_SXM = HardwareModel("h100_sxm", peak_flops=67e12,
                         peak_int8_ops=1979e12, hbm_bw=3.35e12,
                         dispatch_overhead_s=4.076e-4)


@dataclasses.dataclass(frozen=True)
class PlanEstimate:
    """Static roofline estimate of one compiled plan (per sample)."""
    rows: tuple                  # per-op dicts: op/precision/flops/bytes/t_*
    hw: HardwareModel
    data_shards: int = 1

    @property
    def t_compute(self) -> float:
        return sum(r["t_compute"] for r in self.rows)

    @property
    def t_memory(self) -> float:
        return sum(r["t_memory"] for r in self.rows)

    @property
    def total_s(self) -> float:
        """Estimated seconds a sample: the per-op bound times, split over
        the data shards, plus the fixed dispatch overhead."""
        t = sum(r["t_bound"] for r in self.rows)
        return t / max(self.data_shards, 1) + self.hw.dispatch_overhead_s

    @property
    def sps(self) -> float:
        return 1.0 / self.total_s

    @property
    def bottleneck(self) -> str:
        return "compute" if self.t_compute >= self.t_memory else "memory"

    def to_rows(self):
        """JSON-ready per-op rows for the BENCH artifact."""
        return [dict(r) for r in self.rows]


def _op_precision(plan, op: str) -> str:
    """The precision an op row of ``cost_breakdown`` runs under."""
    if op.startswith("stage"):
        s = int(op.split(".")[0][len("stage"):]) - 1
        return plan.stage_precision[s]
    return plan.precision            # embed / head


def _ceil_waste(dim: int, tile: int) -> float:
    """ceil(dim/tile)*tile / dim: the padded-grid inflation of one matmul
    dimension under one tile size."""
    if dim <= 0:
        return 1.0
    return (math.ceil(dim / tile) * tile) / dim


def _tile_waste(plan, cfg, op: str) -> float:
    """Padding-waste multiplier (>= 1) on a matmul op's compute term on the
    ``cuda`` backend: every matmul dimension rounds up to its tile of
    ``plan.tuning``, read exactly as ``repro.roofline._tile_waste`` reads
    it on ``pallas``.  The CUDA kernels pick their own templates and do
    not take ``KernelTuning`` yet (ROADMAP.md Queue 1 item 5 (b)), so this
    term models JAX's tiles, not the card's.  Ops on other backends, and
    the gather/normalize ``group`` rows, return 1.0.
    """
    from repro_torch.api.plan import _KERNEL_BACKENDS
    t = plan.tuning
    if op.startswith("stage"):
        s = int(op.split(".")[0][len("stage"):]) - 1
        if plan.stage_backend[s] not in _KERNEL_BACKENDS:
            return 1.0
        tm, tk, tn = (t.int8_matmul if plan.stage_precision[s] == "int8"
                      else t.fused_linear)
        kind = op.split(".")[1]
        smp, c = cfg.stage_samples[s], cfg.stage_dims[s]
        c_prev = cfg.stage_dims[s - 1] if s else cfg.embed_dim
        k = cfg.k_neighbors
        if kind == "group":
            return 1.0
        if kind == "transfer":
            return (_ceil_waste(smp * k, tm) * _ceil_waste(2 * c_prev, tk)
                    * _ceil_waste(c, tn))
        # pre/pos residual blocks: two matmuls (c->mid, mid->c), the mean
        # of their waste.
        mid = max(1, int(c * cfg.res_expansion))
        m = smp * k if kind == "pre" else smp
        w1 = _ceil_waste(m, tm) * _ceil_waste(c, tk) * _ceil_waste(mid, tn)
        w2 = _ceil_waste(m, tm) * _ceil_waste(mid, tk) * _ceil_waste(c, tn)
        return 0.5 * (w1 + w2)
    if op == "head" and plan.backend in _KERNEL_BACKENDS:
        tm, tk, tn = (t.int8_matmul if plan.precision == "int8"
                      else t.fused_linear)
        m = cfg.n_points if plan.head == "seg" else 1
        c_in = (cfg.embed_dim + 2 * cfg.stage_dims[-1]
                if plan.head == "seg" else cfg.stage_dims[-1])
        w1 = _ceil_waste(m, tm) * _ceil_waste(c_in, tk) * _ceil_waste(512, tn)
        w2 = _ceil_waste(m, tm) * _ceil_waste(512, tk) * _ceil_waste(256, tn)
        w3 = (_ceil_waste(m, tm) * _ceil_waste(256, tk)
              * _ceil_waste(cfg.n_classes, tn))
        return (w1 + w2 + w3) / 3.0
    return 1.0


def estimate_plan(plan, cfg, hw: HardwareModel = H100_SXM,
                  *, data_shards: int = 1) -> PlanEstimate:
    """Score a compiled :class:`~repro_torch.api.plan.StagePlan` statically.

    Each ``cost_breakdown`` row's FLOPs (times the tile waste) divide by
    the peak its precision buys, its weight and activation bytes by the
    memory rate, and the op's bound is the larger of the two: int8 stages
    shrink both terms and a fused group->transfer stage drops the grouped
    tensor's traffic, so the estimate ranks the tuner's space as the
    paper's design-space exploration does.
    """
    rows = []
    for row in plan.cost_breakdown(cfg):
        prec = _op_precision(plan, row["op"])
        peak = hw.peak_int8_ops if prec == "int8" else hw.peak_flops
        nbytes = row["w_bytes"] + row["act_bytes"]
        t_c = row["flops"] * _tile_waste(plan, cfg, row["op"]) / peak
        t_m = nbytes / hw.hbm_bw
        rows.append({"op": row["op"], "precision": prec,
                     "flops": row["flops"], "w_bytes": row["w_bytes"],
                     "act_bytes": row["act_bytes"],
                     "t_compute": t_c, "t_memory": t_m,
                     "t_bound": max(t_c, t_m)})
    return PlanEstimate(rows=tuple(rows), hw=hw,
                        data_shards=max(int(data_shards), 1))
