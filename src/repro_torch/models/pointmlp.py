"""PointMLP-Elite / Lite / M-2 (HLS4PC §3; Ma et al. 2022), in PyTorch.

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
else is in its dispatch, nor on how many lanes it has: the head's last
product runs on the head's backend too (on the card an fp32 one is the
in-order ``fused_linear`` kernel, not cuBLAS, whose kernel changes with
the row count), and on the CPU a lone row's product sums as a wider
one's (``kernels.ref.matmul``).

Training.  ``pointmlp_apply(..., train=True)`` walks the uniform plan
of ``lower_config`` with every CBR on :func:`_cbr_apply`: the fake-quant
matmul under an enabled quant, BN on the batch's mean and population
variance, and a params tree with the refreshed running stats returned
beside the logits (functional BN, as ``repro.models.pointmlp``).  It
samples per cloud (no shared URS) and normalizes with one sigma over the
batch.  The kNN (and FPS) indices still come from the hand-written
kernels on CUDA tensors; every product is a plain ``torch.matmul``, as
JAX trains on ``backend="ref"``.  Pools are ``amax``, whose gradient
splits a tie evenly, as ``reduce_max``'s does.

Stream caches.  A ``stream=True`` plan marks its mapping ops ``cached``:
``collect_cache`` returns what they computed (sampled indices, neighbour
lists, the seg head's 1-NN index; batch-leading tensors on the clouds'
device), and ``mapping_cache`` replays them, as ``repro.models.pointmlp.
_forward_impl`` does, so a frame of a stream skips its mapping kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.api import plan as stage_plan
from repro_torch.api import registry
from repro_torch.core import knn as knn_core
from repro_torch.core.fusion import batch_moments, running_stats
from repro_torch.core.quant import QuantConfig
from repro_torch.core.sampling import gather_points
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

def _tile(tile) -> Dict:
    """The ``tile=`` keyword of a sampler or grouper call: only where the
    plan pins one, so an entry without the keyword runs the default."""
    return {} if tile is None else {"tile": tile}


def _cbr_apply(p: Dict, x: torch.Tensor, cfg: PointMLPConfig, train: bool,
               act: bool = True) -> Tuple[torch.Tensor, Dict]:
    """Conv(+BN)(+ReLU) on the reference lowering.  In train mode BN uses
    the batch's mean and population variance, and the returned params
    carry the refreshed running stats (detached: they are state, not a
    function of the weights' gradient)."""
    quant = cfg.quant if cfg.quant.enabled else None
    y = L._matmul(x, p["w"], quant)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    p_new = p
    if "bn" in p:
        bn = p["bn"]
        if train:
            mu, var = batch_moments(y)
            p_new = dict(p, bn=running_stats(bn, mu.detach(), var.detach(),
                                             cfg.bn_momentum))
        else:
            mu, var = bn["mean"], bn["var"]
        y = (y - mu) * torch.rsqrt(var + 1e-5) * bn["gamma"] + bn["beta"]
    if act:
        y = torch.relu(y)
    return y, p_new


def _forward_impl(params: Dict, cfg: PointMLPConfig, xyz: torch.Tensor,
                  lfsr_state: Optional[torch.Tensor], *, sampler, grouper,
                  plan, train: bool = False, shared_urs: bool = False,
                  per_sample_norm: bool = False,
                  mapping_cache: Optional[Dict] = None,
                  collect_cache: bool = False):
    """Interpret ``plan`` over a batch of clouds.

    ``train`` runs every CBR op on :func:`_cbr_apply` with batch BN
    statistics (the ops' own backends are bypassed, as in JAX) and the
    head's fc3 under the config's quant; a fused group->transfer op
    raises ``ValueError`` there, as JAX's does.

    ``mapping_cache`` replays the mapping results of the ops the plan
    marked ``cached``: sampled indices (only for a sampler whose
    ``advances_state`` is False: URS still runs, so its LFSR state walks
    as on the cold path), neighbour lists (the grouper's
    ``neighbor_index``; its ``group_with_idx`` always recomputes) and
    the seg head's 1-NN index.  ``collect_cache`` also returns the cache
    ``{"sample": (idx, ...), "nbr": (nbr, ...)[, "up": idx]}`` this pass
    computed.  With neither, this is the plain walk.

    Returns (logits [B, n_classes], or [B, n_points, n_classes] for the
    seg head; the params tree, with refreshed BN stats in train mode;
    advanced LFSR state; the collected cache or None).
    """
    def cbr(op, p, x):
        if train:
            return _cbr_apply(p, x, cfg, True, op.act)
        return op.fn(p, x, op.quant, op.act), p

    def fc3(op, p, x):
        if train:
            return L.conv1d_apply(p, x, quant=cfg.quant if cfg.quant.enabled
                                  else None)
        # the head's last layer runs on the head's backend (fc1's) without
        # activation: on the card an fp32 fc3 is then the fused_linear
        # kernel, whose rows do not depend on M (cuBLAS picks its kernel
        # by M, so a cloud's logits would depend on the dispatch width)
        return op.fc1.fn(p, x, op.fc3_quant, False)

    new_params = dict(params)
    new_stages = [dict(st, pre=[], pos=[]) for st in params["stages"]]
    cur_xyz, cur, idx, logits = xyz, None, None, None
    embed = None
    got_sample, got_nbr, got_up = [], [], None
    for op in plan.ops:
        if isinstance(op, stage_plan.EmbedOp):
            cur, new_params["embed"] = cbr(op.cbr, params["embed"], xyz)
            embed = cur
        elif isinstance(op, stage_plan.SampleOp):
            if (op.cached and mapping_cache is not None
                    and not getattr(sampler, "advances_state", True)):
                idx = mapping_cache["sample"][op.stage]
            else:
                idx, lfsr_state = sampler(cur_xyz, op.n_samples, lfsr_state,
                                          shared_urs, **_tile(op.tile))
            if collect_cache:
                got_sample.append(idx)
        elif isinstance(op, stage_plan.GroupOp):
            affine = params["stages"][op.stage].get("affine")
            if op.cached and (mapping_cache is not None or collect_cache):
                # the split grouper: group_with_idx(.., neighbor_index(..))
                # is the whole grouper bit for bit
                if mapping_cache is not None:
                    nbr = mapping_cache["nbr"][op.stage]
                else:
                    nbr = grouper.neighbor_index(
                        gather_points(cur_xyz, idx), cur_xyz, op.k,
                        **_tile(op.tile))
                if collect_cache:
                    got_nbr.append(nbr)
                cur_xyz, _, cur = grouper.group_with_idx(
                    cur_xyz, cur, idx, nbr, affine, cfg.affine_mode,
                    per_sample_norm)
            else:
                cur_xyz, _, cur = grouper(cur_xyz, cur, idx, op.k, affine,
                                          cfg.affine_mode, per_sample_norm,
                                          **_tile(op.tile))
        elif isinstance(op, stage_plan.CBROp):
            # bare CBR ops are the stage transfers
            cur, new_stages[op.stage]["transfer"] = cbr(
                op, stage_plan.param_at(params, op.path), cur)
        elif isinstance(op, stage_plan.FusedGroupTransferOp):
            if train:
                raise ValueError(
                    "fused group->transfer ops are inference-only; "
                    "train with fused_group='none'")
            affine = params["stages"][op.stage].get("affine")
            p = stage_plan.param_at(params, op.cbr.path)
            cur_xyz, _, cur = op.fn(p, cur_xyz, cur, idx, op.k, affine,
                                    cfg.affine_mode, per_sample_norm,
                                    act=op.cbr.act)
        elif isinstance(op, stage_plan.ResBlockOp):
            blk = params["stages"][op.stage][op.branch][op.index]
            h, n1 = cbr(op.net1, blk["net1"], cur)
            h, n2 = cbr(op.net2, blk["net2"], h)
            cur = torch.relu(h + cur)
            new_stages[op.stage][op.branch].append({"net1": n1, "net2": n2})
        elif isinstance(op, stage_plan.PoolOp):
            cur = cur.amax(dim=op.axis)
        elif isinstance(op, stage_plan.HeadOp):
            head = params["head"]
            h, f1 = cbr(op.fc1, head["fc1"], cur)
            h, f2 = cbr(op.fc2, head["fc2"], h)
            logits = fc3(op, head["fc3"], h)
            new_params["head"] = {"fc1": f1, "fc2": f2, "fc3": head["fc3"]}
        elif isinstance(op, stage_plan.SegHeadOp):
            g = cur.amax(dim=1)                                 # [B, C4]
            if op.cached and mapping_cache is not None:
                up_idx = mapping_cache["up"]
            else:
                up_idx = knn_core.knn_batched(xyz, cur_xyz, 1,
                                              op.knn_tile)      # [B, N, 1]
            if collect_cache:
                got_up = up_idx
            up = knn_core.gather_neighbors(cur, up_idx)[:, :, 0, :]
            h = torch.cat([embed, up,
                           g[:, None, :].expand(-1, up.shape[1], -1)], dim=-1)
            head = params["head"]
            h, f1 = cbr(op.fc1, head["fc1"], h)
            h, f2 = cbr(op.fc2, head["fc2"], h)
            logits = fc3(op, head["fc3"], h)
            new_params["head"] = {"fc1": f1, "fc2": f2, "fc3": head["fc3"]}
        else:
            raise TypeError(f"unknown stage-plan op {type(op).__name__}")
    new_params["stages"] = new_stages
    cache = None
    if collect_cache:
        cache = {"sample": tuple(got_sample), "nbr": tuple(got_nbr)}
        if got_up is not None:
            cache["up"] = got_up
    return logits, new_params, lfsr_state, cache


def pointmlp_infer_with(params: Dict, cfg: PointMLPConfig, xyz: torch.Tensor,
                        lfsr_state: Optional[torch.Tensor] = None, *,
                        sampler, grouper, plan, shared_urs: bool = False,
                        per_sample_norm: bool = False,
                        mapping_cache: Optional[Dict] = None,
                        collect_cache: bool = False):
    """Inference forward over resolved pipeline components.

    ``repro_torch.api.build`` resolves the spec's registry keys, lowers
    the plan once and calls this.  The whole batch runs as one dispatch
    (see the module docstring for the per-lane quantities), so a stream
    cache is batch-leading tensors on the clouds' device; see
    :func:`_forward_impl` for ``mapping_cache`` and ``collect_cache``.

    Returns (logits [B, n_classes], or [B, n_points, n_classes] for the
    seg head; advanced LFSR state[, the collected cache]).
    """
    with torch.inference_mode():
        logits, _, state, cache = _forward_impl(
            params, cfg, xyz, lfsr_state, sampler=sampler, grouper=grouper,
            plan=plan, shared_urs=shared_urs,
            per_sample_norm=per_sample_norm, mapping_cache=mapping_cache,
            collect_cache=collect_cache)
    if collect_cache:
        return logits, state, cache
    return logits, state


def pointmlp_apply(params: Dict, cfg: PointMLPConfig, xyz: torch.Tensor,
                   lfsr_state: Optional[torch.Tensor] = None,
                   train: bool = False):
    """Training-facing forward over the uniform plan of
    ``plan.lower_config`` (``repro.models.pointmlp.pointmlp_apply``).

    Samples with ``cfg.sampler``, groups by kNN and runs every CBR on the
    ``ref`` backend; one LFSR stream per cloud (no shared URS) and one
    normalization sigma over the batch.  ``train=True`` uses batch BN
    statistics (differentiable: take gradients with ``torch.autograd``)
    and returns the params with refreshed running stats; eval mode runs
    :func:`pointmlp_infer_with` (no autograd) and returns ``params``
    unchanged.

    Returns (logits [B, n_classes], params, advanced LFSR state).
    """
    sampler, grouper, backend = registry.resolve(cfg.sampler, "knn", "ref")
    plan = stage_plan.lower_config(cfg, backend, "ref")
    if not train:
        logits, state = pointmlp_infer_with(
            params, cfg, xyz, lfsr_state, sampler=sampler, grouper=grouper,
            plan=plan)
        return logits, params, state
    logits, new_params, state, _ = _forward_impl(
        params, cfg, xyz, lfsr_state, sampler=sampler, grouper=grouper,
        plan=plan, train=True)
    return logits, new_params, state


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
