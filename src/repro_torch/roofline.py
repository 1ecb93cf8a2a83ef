"""Roofline terms: a dry-run cell's roofline and the tuner's plan estimate.

:class:`Roofline` is ``repro.roofline.Roofline`` for the dry-run
(``launch/dryrun.py``): a step's per-device FLOPs and memory bytes
against a :class:`HardwareModel`'s peaks, ``t_compute``, ``t_memory``,
``t_collective`` and the largest of them as the ``bottleneck``.  The
collective term comes from a rank's log of the collectives its program
issues (``sharding.collectives.record``, :meth:`Roofline.from_log`),
priced with JAX's ring model (:func:`wire_bytes`, the port's own copy of
``repro.roofline.parse_collectives``' rule): a group whose ranks sit in
one node of ``node_size`` GPUs sends at ``link_bw`` (NVLink), any other
at ``net_bw`` (the node's network).  Where no collective was counted
(``coll_wire_bytes`` None) ``t_collective`` is None and ``bottleneck``
ranges over compute and memory.  The hardware is
:data:`H100_SXM_BF16`, an LM's peaks on one H100 in a DGX H100-style
node.

The plan-scope half of ``repro.roofline``: score a
:class:`~repro_torch.api.plan.StagePlan` from its analytic
``cost_breakdown`` (per-op FLOPs, weight bytes, activation bytes) against
a :class:`HardwareModel`, with no device and no compiled program, so the
search can rank the whole spec space and spend measurement time on the
promising candidates.  Each op is compute- or memory-bound on its own;
the estimate sums the per-op bounds.  Like JAX's, it counts no kNN or
FPS work (``cost_breakdown`` has no row for them).

``parse_collectives`` and ``from_compiled`` read XLA's output and are
not ported; the port has no HLO.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Optional


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Peak rates the per-op roofline terms divide by.

    ``peak_int8_ops`` prices ops whose region resolved to int8;
    ``dispatch_overhead_s`` is a fixed floor a sample (launches, host
    work) so that tiny plans do not estimate as free.
    """
    name: str
    peak_flops: float            # FLOP/s per device (its dtype: the name's)
    peak_int8_ops: float         # int8 OP/s per device
    hbm_bw: float                # device-memory bytes/s
    dispatch_overhead_s: float = 0.0
    link_bw: float = 0.0         # bytes/s a device sends within its node
    net_bw: float = 0.0          # bytes/s a device sends to other nodes
    node_size: int = 1           # devices a node


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

#: An LM step on one NVIDIA H100 SXM (data sheet, dense, at the 700 W
#: limit; the card the chip runs use is an NVIDIA H100 80GB HBM3 at
#: 700.00 W): bf16 tensor cores at 989 TFLOP/s, int8 at 1979 TOP/s (2x),
#: HBM3 at 3.35 TB/s.  The collective term's node is a DGX H100's: 8
#: GPUs, each with NVLink 4 at 900 GB/s, the two directions summed, so
#: a GPU sends at 450 GB/s (the ring model counts bytes sent), and one
#: 400 Gb/s NDR InfiniBand port a GPU to other nodes, 50 GB/s sent.
H100_SXM_BF16 = HardwareModel("h100_sxm_bf16", peak_flops=989e12,
                              peak_int8_ops=1979e12, hbm_bw=3.35e12,
                              link_bw=450e9, net_bw=50e9, node_size=8)


def wire_bytes(op: str, size: float, n: int) -> float:
    """Bytes one device sends for a collective over ``n`` ranks whose
    size (JAX's: an all-reduce's, all-to-all's or collective-permute's
    operand, an all-gather's or reduce-scatter's result) is ``size``: the
    ring model of ``repro.roofline.parse_collectives``, all-reduce
    ``2(n-1)/n``, all-gather and all-to-all ``(n-1)/n``, reduce-scatter
    ``n-1`` times it, a permute the size.  A group of one rank sends
    nothing."""
    if n <= 1:
        return 0.0
    frac = (n - 1) / n
    if op == "all-reduce":
        return 2.0 * frac * size
    if op in ("all-gather", "all-to-all"):
        return frac * size
    if op == "reduce-scatter":
        return (n - 1) * float(size)
    if op == "collective-permute":
        return float(size)
    raise ValueError(f"unknown collective {op!r}")


def within_node(ranks: Iterable[int], hw: "HardwareModel") -> bool:
    """Whether a group of these global ranks sits in one node of
    ``hw.node_size`` devices (ranks laid row-major, as
    ``launch.mesh.make_group_mesh`` lays them)."""
    return len({r // hw.node_size for r in ranks}) <= 1


@dataclasses.dataclass
class Roofline:
    """One step's roofline on one device of ``hw``."""
    flops: float                 # per-device FLOPs
    hbm_bytes: float             # per-device memory bytes
    coll_bytes: Optional[float] = None       # per-device collective bytes
    coll_wire_bytes: Optional[float] = None
    coll_by_type: Optional[Dict[str, float]] = None
    model_flops: Optional[float] = None   # 6·N·D (or 2·N·D fwd-only), global
    hw: HardwareModel = H100_SXM_BF16
    # of coll_wire_bytes, those sent by groups that span nodes
    coll_wire_bytes_across_nodes: Optional[float] = None

    @classmethod
    def from_log(cls, flops: float, hbm_bytes: float, log,
                 model_flops: Optional[float] = None,
                 hw: HardwareModel = H100_SXM_BF16) -> "Roofline":
        """The roofline of a device whose program issued the
        collectives of ``log`` (``sharding.collectives.Collective``s):
        their sizes summed by op (JAX's ``coll_by_type``) and their wire
        bytes (:func:`wire_bytes`), those of groups that span nodes
        apart (:func:`within_node`)."""
        by_type: Dict[str, float] = {}
        wire = across = 0.0
        for c in log:
            by_type[c.op] = by_type.get(c.op, 0.0) + float(c.bytes)
            w = wire_bytes(c.op, c.bytes, c.group_size)
            wire += w
            if not within_node(c.ranks, hw):
                across += w
        return cls(flops=flops, hbm_bytes=hbm_bytes,
                   coll_bytes=sum(by_type.values()), coll_wire_bytes=wire,
                   coll_by_type=by_type, model_flops=model_flops, hw=hw,
                   coll_wire_bytes_across_nodes=across)

    @property
    def t_compute(self) -> float:
        return self.flops / self.hw.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.hw.hbm_bw

    @property
    def t_collective(self) -> Optional[float]:
        """The wire bytes within a node over ``link_bw`` plus those across
        nodes over ``net_bw``; None where no collective was counted."""
        if self.coll_wire_bytes is None:
            return None
        across = self.coll_wire_bytes_across_nodes or 0.0
        inside = self.coll_wire_bytes - across
        return (inside / self.hw.link_bw if inside else 0.0) + \
            (across / self.hw.net_bw if across else 0.0)

    def _terms(self) -> Dict[str, float]:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return {k: v for k, v in ts.items() if v is not None}

    @property
    def bottleneck(self) -> str:
        ts = self._terms()
        return max(ts, key=ts.get)

    @property
    def t_bound(self) -> float:
        return max(self._terms().values())

    def useful_flops_ratio(self, n_chips: int) -> Optional[float]:
        if not self.model_flops:
            return None
        return self.model_flops / (self.flops * n_chips)

    def roofline_fraction(self, n_chips: int) -> Optional[float]:
        """MODEL_FLOPS-achievable fraction: useful work at peak against
        the modelled bound time."""
        if not self.model_flops or self.t_bound == 0:
            return None
        t_useful = self.model_flops / n_chips / self.hw.peak_flops
        return t_useful / self.t_bound

    def to_dict(self) -> Dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "coll_wire_bytes": self.coll_wire_bytes,
            "coll_wire_bytes_across_nodes":
                self.coll_wire_bytes_across_nodes,
            "coll_by_type": self.coll_by_type,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck, "hardware": self.hw.name,
        }


def model_flops_estimate(n_active_params: int, tokens: int,
                         kind: str) -> float:
    """6·N·D for training, 2·N·D for forward-only (prefill/decode)."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active_params * tokens


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


def _gemm_waste(kernel: str, m: int, k: int, n: int, tile=None,
                rows: int = 0) -> float:
    """Padding waste of one product on the card: ``[m, k] @ [k, n]`` on
    the template the wrapper launches (its own rule, or the one ``tile``
    pins, with aligned operands), every dimension rounded up to the
    template's: M to BM (per cloud of ``rows`` rows for
    ``grouped_transfer``, whose grid is per cloud), N to BN, and K to the
    64-byte chunks ``int8_matmul`` computes whole (the fp32 chains end at
    K)."""
    from repro_torch.kernels import fused_linear, grouped_transfer
    from repro_torch.kernels import int8_matmul, tuning
    if kernel == "int8_matmul":
        t = int8_matmul.template(k, n, True, tile)
        bm, bk, bn = tuning.template_tile(kernel, t.bn, vec=t.vec)
        return (_ceil_waste(m, bm) * _ceil_waste(k, bk)
                * _ceil_waste(n, bn))
    if kernel == "grouped_transfer":
        t = grouped_transfer.template(m, k // 2, n, True, tile=tile)
        bm, _, bn = tuning.template_tile(kernel, t.bn)
        return _ceil_waste(rows, bm) * _ceil_waste(n, bn)
    t = fused_linear.template(m, k, n, True, tile=tile)
    bm, _, bn = tuning.template_tile(kernel, t.bn, t.small)
    return _ceil_waste(m, bm) * _ceil_waste(n, bn)


def _tile_waste(plan, cfg, op: str, batch: int = 1) -> float:
    """Padding-waste multiplier (>= 1) on a product op's compute term on
    the ``cuda`` backend, at a dispatch of ``batch`` clouds: each product
    of the op on the template its kernel launches (:func:`_gemm_waste`),
    ``int8_matmul`` for int8 regions, ``fused_linear`` for fp32 ones and
    ``grouped_transfer`` for a fused stage's transfer, by the wrapper's
    rule or as ``plan.tuning`` pins it.  A residual block's two products
    and the head's three count as their mean, as in
    ``repro.roofline._tile_waste``.  Ops on other backends, and the
    gather/normalize ``group`` rows, return 1.0 (as JAX's do off
    ``pallas``).
    """
    from repro_torch.api.plan import _KERNEL_BACKENDS, FusedGroupTransferOp
    from repro_torch.kernels import tuning

    def gemm(prec: str, m: int, k: int, n: int) -> float:
        kernel = "int8_matmul" if prec == "int8" else "fused_linear"
        return _gemm_waste(kernel, m, k, n,
                           tuning.pinned(kernel, plan.tuning))

    if op.startswith("stage"):
        s = int(op.split(".")[0][len("stage"):]) - 1
        kind = op.split(".")[1]
        if plan.stage_backend[s] not in _KERNEL_BACKENDS or kind == "group":
            return 1.0
        prec = plan.stage_precision[s]
        smp, c = cfg.stage_samples[s], cfg.stage_dims[s]
        c_prev = cfg.stage_dims[s - 1] if s else cfg.embed_dim
        k = cfg.k_neighbors
        if kind == "transfer":
            fused = any(isinstance(o, FusedGroupTransferOp) and o.stage == s
                        for o in plan.ops)
            if fused:
                return _gemm_waste(
                    "grouped_transfer", batch * smp * k, 2 * c_prev, c,
                    tuning.pinned("grouped_transfer", plan.tuning),
                    rows=smp * k)
            return gemm(prec, batch * smp * k, 2 * c_prev, c)
        mid = max(1, int(c * cfg.res_expansion))
        m = batch * (smp * k if kind == "pre" else smp)
        return 0.5 * (gemm(prec, m, c, mid) + gemm(prec, m, mid, c))
    if plan.backend not in _KERNEL_BACKENDS:
        return 1.0
    if op == "embed":
        return gemm(plan.precision, batch * cfg.n_points, 3, cfg.embed_dim)
    if op == "head":
        m = batch * (cfg.n_points if plan.head == "seg" else 1)
        c_in = (cfg.embed_dim + 2 * cfg.stage_dims[-1]
                if plan.head == "seg" else cfg.stage_dims[-1])
        return (gemm(plan.precision, m, c_in, 512)
                + gemm(plan.precision, m, 512, 256)
                + gemm(plan.precision, m, 256, cfg.n_classes)) / 3.0
    return 1.0


def estimate_plan(plan, cfg, hw: HardwareModel = H100_SXM,
                  *, data_shards: int = 1, batch: int = 1) -> PlanEstimate:
    """Score a compiled :class:`~repro_torch.api.plan.StagePlan` statically.

    Each ``cost_breakdown`` row's FLOPs (times the tile waste of a
    dispatch of ``batch`` clouds) divide by the peak its precision buys,
    its weight and activation bytes by the memory rate, and the op's bound
    is the larger of the two: int8 stages shrink both terms and a fused
    group->transfer stage drops the grouped tensor's traffic, so the
    estimate ranks the tuner's space as the paper's design-space
    exploration does.
    """
    rows = []
    for row in plan.cost_breakdown(cfg):
        prec = _op_precision(plan, row["op"])
        peak = hw.peak_int8_ops if prec == "int8" else hw.peak_flops
        nbytes = row["w_bytes"] + row["act_bytes"]
        t_c = row["flops"] * _tile_waste(plan, cfg, row["op"], batch) / peak
        t_m = nbytes / hw.hbm_bw
        rows.append({"op": row["op"], "precision": prec,
                     "flops": row["flops"], "w_bytes": row["w_bytes"],
                     "act_bytes": row["act_bytes"],
                     "t_compute": t_c, "t_memory": t_m,
                     "t_bound": max(t_c, t_m)})
    return PlanEstimate(rows=tuple(rows), hw=hw,
                        data_shards=max(int(data_shards), 1))
