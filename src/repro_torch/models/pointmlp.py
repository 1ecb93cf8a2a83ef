"""PointMLP-Elite / Lite / M-2 inference (HLS4PC §3; Ma et al. 2022), in PyTorch.

Topology: pointwise-conv embedding -> 4 stages of (sample, kNN group
with geometric-affine normalize, transfer CBR, pre residual blocks on
[B,S,k,C], max-pool over k, pos residual blocks on [B,S,C]) -> global
max-pool -> 3-layer classifier; or, with the seg head, per-point logits
over ``[embed, last stage upsampled by 1-NN, global max]``.  Elite (the paper's baseline) samples
with FPS, keeps the learnable affine (alpha, beta) and runs fp32 at
1024 points; M-2 and Lite sample with URS at 512 points, with alpha and
beta pruned.  The walk interprets the op plan of ``repro_torch.api.plan.
lower``, as ``repro.models.pointmlp._forward_impl`` does; under
``fused_group`` each stage's group + transfer pair is one fused op.

Batched serving.  Under serving semantics (``shared_urs`` and
``per_sample_norm``) the JAX walk maps a one-cloud program over the
lanes.  This walk runs the whole dispatch as one batch, one kernel
launch per layer, and keeps every per-lane quantity per lane: the int8
activation scale (``QuantConfig.per_lane``, set at lowering), the
normalization sigma (a mean per cloud), and one shared URS index
sequence (FPS is per cloud by nature).  Every kernel sums in an order
fixed by its own lane's data, so a lane's logits do not depend on what
else is in its dispatch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.api import plan as stage_plan
from repro_torch.core import knn as knn_core
from repro_torch.core.quant import QuantConfig
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class PointMLPConfig:
    name: str = "pointmlp-elite"
    n_points: int = 1024
    n_classes: int = 40
    embed_dim: int = 32
    k_neighbors: int = 16
    stage_expansion: Tuple[int, ...] = (2, 2, 2, 2)
    pre_blocks: Tuple[int, ...] = (1, 1, 2, 1)
    pos_blocks: Tuple[int, ...] = (1, 1, 2, 1)
    res_expansion: float = 0.25
    sampler: str = "fps"
    affine_mode: str = "affine"
    head: str = "cls"
    use_bn: bool = True
    quant: QuantConfig = QuantConfig(w_bits=32, a_bits=32)
    bn_momentum: float = 0.9

    @property
    def stage_samples(self) -> Tuple[int, ...]:
        """Samples halve per stage: 512 points -> (256, 128, 64, 32)."""
        return tuple(self.n_points // (2 ** (i + 1)) for i in range(4))

    @property
    def stage_dims(self) -> Tuple[int, ...]:
        dims, d = [], self.embed_dim
        for e in self.stage_expansion:
            d *= e
            dims.append(d)
        return tuple(dims)

    def replace(self, **kw) -> "PointMLPConfig":
        return dataclasses.replace(self, **kw)


def pointmlp_elite_config(n_classes: int = 40) -> PointMLPConfig:
    return PointMLPConfig(name="pointmlp-elite", n_classes=n_classes)


def pointmlp_m2_config(n_classes: int = 40) -> PointMLPConfig:
    """M-2 of Table 1: 512 points, URS, alpha/beta pruned, BN fused."""
    return PointMLPConfig(name="pointmlp-m2", n_points=512, sampler="urs",
                          affine_mode="norm", n_classes=n_classes)


def pointmlp_lite_config(n_classes: int = 40) -> PointMLPConfig:
    """PointMLP-Lite: M-2 + 8/8-bit quantization."""
    return pointmlp_m2_config(n_classes).replace(
        name="pointmlp-lite", quant=QuantConfig(w_bits=8, a_bits=8))


# ------------------------------------------------------------- init -----

def _cbr_init(g: torch.Generator, c_in: int, c_out: int,
              cfg: PointMLPConfig) -> Dict:
    return L.conv1d_init(g, c_in, c_out, bias=True, bn=cfg.use_bn)


def _res_block_init(g: torch.Generator, c: int, cfg: PointMLPConfig) -> Dict:
    mid = max(1, int(c * cfg.res_expansion))
    return {"net1": _cbr_init(g, c, mid, cfg), "net2": _cbr_init(g, mid, c, cfg)}


def pointmlp_init(cfg: PointMLPConfig, generator: torch.Generator) -> Dict:
    """Random parameters with ``repro.models.pointmlp.pointmlp_init``'s
    tree and distributions (N(0, 1/c_in) weights, zero biases, identity
    BN), drawn from ``generator`` on its device."""
    dev = generator.device
    params: Dict = {"embed": _cbr_init(generator, 3, cfg.embed_dim, cfg)}
    c_prev = cfg.embed_dim
    stages = []
    for s in range(4):
        c_out = cfg.stage_dims[s]
        st: Dict = {}
        if cfg.affine_mode == "affine":
            st["affine"] = {"alpha": torch.ones(c_prev, device=dev),
                            "beta": torch.zeros(c_prev, device=dev)}
        st["transfer"] = _cbr_init(generator, 2 * c_prev, c_out, cfg)
        st["pre"] = [_res_block_init(generator, c_out, cfg)
                     for _ in range(cfg.pre_blocks[s])]
        st["pos"] = [_res_block_init(generator, c_out, cfg)
                     for _ in range(cfg.pos_blocks[s])]
        stages.append(st)
        c_prev = c_out
    params["stages"] = stages
    # The seg head's fc1 takes the per-point concat [embed (E), upsampled
    # last stage (C4), global max (C4)].
    fc1_in = cfg.embed_dim + 2 * c_prev if cfg.head == "seg" else c_prev
    params["head"] = {
        "fc1": _cbr_init(generator, fc1_in, 512, cfg),
        "fc2": _cbr_init(generator, 512, 256, cfg),
        "fc3": L.conv1d_init(generator, 256, cfg.n_classes, bias=True,
                             bn=False),
    }
    return params


def count_conv_layers(cfg: PointMLPConfig) -> int:
    return 1 + sum(1 + 2 * cfg.pre_blocks[s] + 2 * cfg.pos_blocks[s]
                   for s in range(4))


# ------------------------------------------------------------ apply -----

def _forward_impl(params: Dict, cfg: PointMLPConfig, xyz: torch.Tensor,
                  lfsr_state: Optional[torch.Tensor], *, sampler, grouper,
                  plan, shared_urs: bool = False,
                  per_sample_norm: bool = False
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Interpret ``plan`` over a batch of clouds (inference only).

    Returns (logits [B, n_classes], or [B, n_points, n_classes] for the
    seg head; advanced LFSR state).
    """
    def cbr(op, p, x):
        return op.fn(p, x, op.quant, op.act)

    cur_xyz, cur, idx, logits = xyz, None, None, None
    embed = None
    for op in plan.ops:
        if isinstance(op, stage_plan.EmbedOp):
            cur = embed = cbr(op.cbr, params["embed"], xyz)
        elif isinstance(op, stage_plan.SampleOp):
            idx, lfsr_state = sampler(cur_xyz, op.n_samples, lfsr_state,
                                      shared_urs)
        elif isinstance(op, stage_plan.GroupOp):
            affine = params["stages"][op.stage].get("affine")
            cur_xyz, _, cur = grouper(cur_xyz, cur, idx, op.k, affine,
                                      cfg.affine_mode, per_sample_norm)
        elif isinstance(op, stage_plan.CBROp):
            cur = cbr(op, stage_plan.param_at(params, op.path), cur)
        elif isinstance(op, stage_plan.FusedGroupTransferOp):
            affine = params["stages"][op.stage].get("affine")
            p = stage_plan.param_at(params, op.cbr.path)
            cur_xyz, _, cur = op.fn(p, cur_xyz, cur, idx, op.k, affine,
                                    cfg.affine_mode, per_sample_norm,
                                    act=op.cbr.act)
        elif isinstance(op, stage_plan.ResBlockOp):
            blk = params["stages"][op.stage][op.branch][op.index]
            h = cbr(op.net1, blk["net1"], cur)
            h = cbr(op.net2, blk["net2"], h)
            cur = torch.relu(h + cur)
        elif isinstance(op, stage_plan.PoolOp):
            cur = cur.amax(dim=op.axis)
        elif isinstance(op, stage_plan.HeadOp):
            head = params["head"]
            h = cbr(op.fc1, head["fc1"], cur)
            h = cbr(op.fc2, head["fc2"], h)
            logits = L.conv1d_apply(head["fc3"], h, quant=op.fc3_quant)
        elif isinstance(op, stage_plan.SegHeadOp):
            g = cur.amax(dim=1)                                 # [B, C4]
            up_idx = knn_core.knn_batched(xyz, cur_xyz, 1)      # [B, N, 1]
            up = knn_core.gather_neighbors(cur, up_idx)[:, :, 0, :]
            h = torch.cat([embed, up,
                           g[:, None, :].expand(-1, up.shape[1], -1)], dim=-1)
            head = params["head"]
            h = cbr(op.fc1, head["fc1"], h)
            h = cbr(op.fc2, head["fc2"], h)
            logits = L.conv1d_apply(head["fc3"], h, quant=op.fc3_quant)
        else:
            raise TypeError(f"unknown stage-plan op {type(op).__name__}")
    return logits, lfsr_state


def pointmlp_infer_with(params: Dict, cfg: PointMLPConfig, xyz: torch.Tensor,
                        lfsr_state: Optional[torch.Tensor] = None, *,
                        sampler, grouper, plan, shared_urs: bool = False,
                        per_sample_norm: bool = False
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Inference forward over resolved pipeline components.

    ``repro_torch.api.build`` resolves the spec's registry keys, lowers
    the plan once and calls this.  The whole batch runs as one dispatch
    (see the module docstring for the per-lane quantities).

    Returns (logits [B, n_classes], or [B, n_points, n_classes] for the
    seg head; advanced LFSR state).
    """
    with torch.inference_mode():
        return _forward_impl(params, cfg, xyz, lfsr_state, sampler=sampler,
                             grouper=grouper, plan=plan,
                             shared_urs=shared_urs,
                             per_sample_norm=per_sample_norm)


def pointmlp_flops_breakdown(cfg: PointMLPConfig) -> Dict[str, int]:
    """Analytic MAC*2 count per sample, per stage op (sums to
    :func:`pointmlp_flops`), as in ``repro.models.pointmlp``."""
    fl: Dict[str, int] = {}
    n = cfg.n_points
    fl["embed"] = 2 * n * 3 * cfg.embed_dim
    c_prev = cfg.embed_dim
    for s in range(4):
        smp, c = cfg.stage_samples[s], cfg.stage_dims[s]
        k = cfg.k_neighbors
        fl[f"stage{s + 1}.group"] = 2 * smp * n * 3
        fl[f"stage{s + 1}.transfer"] = 2 * smp * k * (2 * c_prev) * c
        mid = max(1, int(c * cfg.res_expansion))
        fl[f"stage{s + 1}.pre"] = (cfg.pre_blocks[s] * 2 * smp * k
                                   * (c * mid + mid * c))
        fl[f"stage{s + 1}.pos"] = (cfg.pos_blocks[s] * 2 * smp
                                   * (c * mid + mid * c))
        n, c_prev = smp, c
    if cfg.head == "seg":
        # the 1-NN upsample's distances, then the classifier per point
        n0 = cfg.n_points
        fl["head"] = (2 * n0 * n * 3
                      + 2 * n0 * ((cfg.embed_dim + 2 * c_prev) * 512
                                  + 512 * 256 + 256 * cfg.n_classes))
    else:
        fl["head"] = 2 * (c_prev * 512 + 512 * 256 + 256 * cfg.n_classes)
    return {op: int(v) for op, v in fl.items()}


def pointmlp_flops(cfg: PointMLPConfig) -> int:
    """Analytic MAC*2 count per sample."""
    return sum(pointmlp_flops_breakdown(cfg).values())
