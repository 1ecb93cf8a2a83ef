"""Fused group -> normalize -> transfer: the CUDA kernels ``csrc/grouped_transfer.cu``.

The port of ``repro.kernels.grouped_transfer``.  For every sample of a
cloud and each of its k neighbours, the kernels gather the neighbour's
features, subtract the centre, normalize by the geometric-affine sigma
(``* alpha + beta`` under ``affine``), concatenate the centre features
and run the transfer layer's ``relu(x @ w + b)``, without the
``[B, S, k, 2C]`` grouped tensor ever reaching device memory.

Two wrappers, one per ``pallas_call`` of the JAX module:

* :func:`grouped_transfer_stats_cuda` computes sigma per cloud inside
  (a stats launch of fixed-order float64 partial sums, then the compute
  launch): ``grouped_transfer.py:149``, serving semantics;
* :func:`grouped_transfer_cuda` takes sigma as given (one per cloud), or
  normalizes not at all (``center``): ``grouped_transfer.py:173``.

Each counts its launches on ``.launches`` and those of each template
by name on ``.templates``.  :func:`fused_group_transfer`
is the batched wrapper of the ``FUSED_OPS`` registry contract (the twin
of ``repro.kernels.grouped_transfer.fused_group_transfer``); on CPU
tensors it runs :func:`repro_torch.kernels.ref.grouped_transfer_ref`.
"""
from __future__ import annotations

import collections
from typing import Optional

import torch

from repro_torch.kernels import _build, fused_linear, ref, tuning

_STATS_SAMPLES = 8              # csrc/grouped_transfer.cu: samples per tile
_MODE_CENTER, _MODE_GIVEN, _MODE_STATS = 0, 1, 2


def _check(feats, nidx, centers, alpha, beta, w, b) -> None:
    if feats.ndim != 3 or nidx.ndim != 3 or centers.ndim != 3:
        raise ValueError(f"grouped_transfer takes feats [B, N, C], nidx "
                         f"[B, S, k] and centers [B, S, C], got "
                         f"{tuple(feats.shape)}, {tuple(nidx.shape)} and "
                         f"{tuple(centers.shape)}")
    bsz, _, c = feats.shape
    s = nidx.shape[1]
    if nidx.shape[0] != bsz or centers.shape != (bsz, s, c):
        raise ValueError(f"grouped_transfer: shapes disagree: feats "
                         f"{tuple(feats.shape)}, nidx {tuple(nidx.shape)}, "
                         f"centers {tuple(centers.shape)}")
    if w.ndim != 2 or w.shape[0] != 2 * c or b.shape != (w.shape[1],):
        raise ValueError(f"grouped_transfer: w must be [2C={2 * c}, C_out] "
                         f"and b [C_out], got {tuple(w.shape)} and "
                         f"{tuple(b.shape)}")
    if alpha.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"grouped_transfer: alpha and beta must be [{c}], "
                         f"got {tuple(alpha.shape)} and {tuple(beta.shape)}")


def template(m: int, c: int, c_out: int, aligned: bool = True,
             sms: int = fused_linear.H100_SMS,
             tile=None) -> _build.GemmTemplate:
    """The template of ``csrc/grouped_transfer.cu`` for ``m = B*S*k`` rows
    of ``[2C]`` times ``w [2C, C_out]``: ``fused_linear``'s rule for the
    same product (the kernel runs its wide tile, of the same BN, where the
    rule names the small one).  A ``tile`` pins the wide tile's rows a
    block (128 or 256), BN following C_out within it
    (``kernels.tuning.grouped_transfer_bn``).  16-byte loads (``vec``)
    also need C % 4 == 0, so that no float4 of a row straddles the centre
    half."""
    if tile is not None:
        rows = tuning.card_tile("grouped_transfer", tile)
        return _build.GemmTemplate(
            tuning.grouped_transfer_bn(rows, c_out),
            aligned and c % 4 == 0 and c_out % 4 == 0)
    return fused_linear.template(m, 2 * c, c_out, aligned and c % 4 == 0,
                                 sms)


def _launch(feats, nidx, centers, sigma, alpha, beta, w, b, *, mode: int,
            affine: bool, act: bool, tile, counter) -> torch.Tensor:
    _check(feats, nidx, centers, alpha, beta, w, b)
    dev = feats.device
    tensors = dict(feats=feats, centers=centers, alpha=alpha, beta=beta,
                   w=w, b=b)
    if sigma is not None:
        tensors["sigma"] = sigma
    for name, t in tensors.items():
        if (not t.is_cuda or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"grouped_transfer kernel needs contiguous "
                             f"float32 CUDA tensors on one device; {name} "
                             f"is {t.dtype} on {t.device}")
    if (not nidx.is_cuda or nidx.dtype != torch.int64
            or not nidx.is_contiguous() or nidx.device != dev):
        raise ValueError(f"grouped_transfer kernel needs contiguous int64 "
                         f"CUDA indices, got {nidx.dtype} on {nidx.device}")
    bsz, n, c = feats.shape
    _, s, k = nidx.shape
    c_out = w.shape[1]
    if max(bsz * n * c, bsz * s * c, s * k) >= 2 ** 31:
        raise ValueError(f"grouped_transfer kernel: row offsets are 32-bit; "
                         f"B*N*C={bsz * n * c}, B*S*C={bsz * s * c}, "
                         f"S*k={s * k}")
    out = torch.empty((bsz, s, k, c_out), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    tmpl = template(bsz * s * k, c, c_out,
                    _build.aligned16(feats, centers, alpha, beta, w),
                    fused_linear._sm_count(dev.index), tile)
    partials = (torch.empty((bsz, -(-s // _STATS_SAMPLES)),
                            dtype=torch.float64, device=dev)
                if mode == _MODE_STATS else None)
    _build.launch(
        "grouped_transfer", dev, feats.data_ptr(), nidx.data_ptr(),
        centers.data_ptr(), None if sigma is None else sigma.data_ptr(),
        alpha.data_ptr(), beta.data_ptr(), w.data_ptr(), b.data_ptr(),
        out.data_ptr(), None if partials is None else partials.data_ptr(),
        bsz, n, s, k, c, c_out, mode, int(affine), int(act), tmpl.code)
    # the small codes run the wide tile of the same BN
    counter[_build.GemmTemplate(tmpl.bn, tmpl.vec).name] += 1
    return out


def grouped_transfer_stats_cuda(feats, nidx, centers, alpha, beta, w, b, *,
                                affine: bool = True, act: bool = True,
                                tile=None) -> torch.Tensor:
    """The stats variant: sigma per cloud, computed inside.  feats
    [B, N, C], nidx int64 [B, S, k], centers [B, S, C], alpha/beta [C],
    w [2C, C_out], b [C_out] (all contiguous, on the card) -> [B, S, k,
    C_out], on the template :func:`template` names (``tile`` pins
    one)."""
    out = _launch(feats, nidx, centers, None, alpha, beta, w, b,
                  mode=_MODE_STATS, affine=affine, act=act, tile=tile,
                  counter=grouped_transfer_stats_cuda.templates)
    grouped_transfer_stats_cuda.launches += 1
    return out


def grouped_transfer_cuda(feats, nidx, centers, sigma, alpha, beta, w, b, *,
                          normalize: bool = True, affine: bool = True,
                          act: bool = True, tile=None) -> torch.Tensor:
    """The given-sigma variant: ``sigma`` f32 [B] (one per cloud; unread
    when ``normalize`` is False), otherwise as
    :func:`grouped_transfer_stats_cuda`."""
    if normalize and sigma is None:
        raise ValueError("grouped_transfer_cuda needs sigma to normalize; "
                         "grouped_transfer_stats_cuda computes it")
    out = _launch(feats, nidx, centers, sigma if normalize else None, alpha,
                  beta, w, b, mode=_MODE_GIVEN if normalize else _MODE_CENTER,
                  affine=affine, act=act, tile=tile,
                  counter=grouped_transfer_cuda.templates)
    grouped_transfer_cuda.launches += 1
    return out


grouped_transfer_stats_cuda.launches = 0
grouped_transfer_stats_cuda.templates = collections.Counter()
grouped_transfer_cuda.launches = 0
grouped_transfer_cuda.templates = collections.Counter()


def grouped_transfer(feats, nidx, centers, sigma, alpha, beta, w, b, *,
                     normalize: bool = True, affine: bool = True,
                     act: bool = True, tile=None) -> torch.Tensor:
    """One of the two kernels for CUDA tensors (the stats variant when
    ``normalize`` and ``sigma is None``), the plain version for CPU
    tensors (``tile`` checked, then unused: the plain version has
    none)."""
    if feats.is_cuda:
        args = [t.contiguous() for t in (feats, nidx, centers)]
        rest = [t.contiguous() for t in (alpha, beta, w, b)]
        if normalize and sigma is None:
            return grouped_transfer_stats_cuda(*args, *rest, affine=affine,
                                               act=act, tile=tile)
        if sigma is not None:
            sigma = sigma.reshape(-1).contiguous()
        return grouped_transfer_cuda(*args, sigma, *rest,
                                     normalize=normalize, affine=affine,
                                     act=act, tile=tile)
    if feats.device.type == "cpu":
        _check(feats, nidx, centers, alpha, beta, w, b)
        if tile is not None:
            tuning.card_tile("grouped_transfer", tile)
        return ref.grouped_transfer_ref(feats, nidx, centers, sigma, alpha,
                                        beta, w, b, normalize=normalize,
                                        affine=affine, act=act)
    raise ValueError(f"grouped_transfer: unsupported device {feats.device}")


def fused_group_transfer(xyz: torch.Tensor, feats: torch.Tensor,
                         sample_idx: torch.Tensor, k: int,
                         affine_params: Optional[dict], mode: str,
                         per_sample_norm: bool, p: dict, *,
                         act: bool = True, tile=None, knn_tile=None):
    """A whole ``GroupOp`` + transfer ``CBROp`` pair, batched over clouds.

    Args mirror the grouper contract (xyz [B, N, 3], feats [B, N, C],
    sample_idx [B, S]) plus the transfer layer's fused fp32 params
    ``p = {"w": [2C, C_out], "b": [C_out]}``.  Returns (new_xyz [B, S, 3],
    centre feats [B, S, C], out [B, S, k, C_out]): the triple of the
    unfused GroupOp + CBROp sequence, the transfer's ReLU applied.

    Per-cloud sigma (``per_sample_norm``) is computed inside the kernel.
    Batch-global sigma reduces across clouds, so it is formed outside by
    ``repro_torch.core.knn.group_sigma`` (as the unfused path forms it)
    and handed to the given-sigma kernel.  ``tile`` and ``knn_tile`` pin
    the ``grouped_transfer`` and ``knn`` templates (``KernelTuning``
    values; None: the wrappers' rules).
    """
    from repro_torch.core import knn as knn_core
    from repro_torch.core.sampling import gather_points
    w = p["w"]
    if isinstance(w, dict) or getattr(w, "ndim", 0) != 2 or "bn" in p:
        raise ValueError(
            "fused_group_transfer needs a fused fp32 transfer layer "
            "(2-D w, BN folded, no int8 export dict); lower this stage "
            "unfused instead")
    c = feats.shape[-1]
    bias = p.get("b")
    if bias is None:
        bias = torch.zeros(w.shape[1], dtype=w.dtype, device=w.device)
    sample_idx = sample_idx.to(xyz.device, torch.int64)
    new_xyz = gather_points(xyz, sample_idx)
    center_f = gather_points(feats, sample_idx)
    nbr_idx = knn_core.knn_batched(new_xyz, xyz, k, tile=knn_tile)

    if mode not in ("affine", "norm", "center"):
        raise ValueError(f"unknown normalize mode: {mode}")
    normalize, affine = mode != "center", mode == "affine"
    if affine:
        if affine_params is None:
            raise ValueError("affine mode needs alpha/beta params for the "
                             "fused group->transfer stage")
        alpha, beta = affine_params["alpha"], affine_params["beta"]
    else:
        alpha = torch.ones(c, dtype=feats.dtype, device=feats.device)
        beta = torch.zeros(c, dtype=feats.dtype, device=feats.device)

    sigma = None
    if normalize and not per_sample_norm:
        off = (knn_core.gather_neighbors(feats, nbr_idx)
               - center_f[:, :, None, :])
        sigma = knn_core.group_sigma(off, per_sample=False,
                                     eps=ref.EPS).expand(feats.shape[0])
    out = grouped_transfer(feats, nbr_idx, center_f, sigma, alpha, beta, w,
                           bias, normalize=normalize, affine=affine, act=act,
                           tile=tile)
    return new_xyz, center_f, out
