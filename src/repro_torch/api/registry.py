"""String-keyed component registries for the pipeline API (HLS4PC §2).

The twin of ``repro.api.registry``: spec fields name samplers, groupers,
CBR backends and fused ops by key, and ``build`` resolves them once.

Entry contracts
---------------
sampler(xyz [B,N,3], n_samples, lfsr_state, shared) ->
    (idx [B,S] int64 on xyz's device, new_lfsr_state)
grouper(xyz, feats, idx, k, affine_params, mode, per_sample_norm) ->
    (new_xyz [B,S,3], center_feats [B,S,C], grouped [B,S,k,2C])
backend(p, x, quant, act) -> y
    one Conv(+folded BN)(+ReLU) inference layer; ``p["w"]`` may be an
    int8 export dict, ``quant`` a QuantConfig or None (fp32).
fused_op(p, xyz, feats, idx, k, affine_params, mode, per_sample_norm,
         act=True) -> (new_xyz [B,S,3], center_feats [B,S,C],
                       out [B,S,k,C_out])
    a GroupOp + transfer CBROp pair in one step; ``p`` is the transfer
    layer's fused fp32 ``{"w", "b"}`` (``spec.fused_group``).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch


class Registry:
    """A named string-key -> callable table with decorator registration.

    Re-registering a key raises; an unknown key raises a ``KeyError``
    that lists every registered name.
    """

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Callable] = {}

    def register(self, name: str) -> Callable[[Callable], Callable]:
        def deco(fn: Callable) -> Callable:
            if name in self._entries:
                raise ValueError(
                    f"{self.kind} {name!r} is already registered; "
                    f"pick a new name")
            self._entries[name] = fn
            return fn
        return deco

    def get(self, name: str) -> Callable:
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(
                f"unknown {self.kind} {name!r}; registered {self.kind}s: "
                f"{', '.join(self.names())}") from None

    def names(self) -> tuple:
        return tuple(sorted(self._entries))

    def __contains__(self, name: str) -> bool:
        return name in self._entries


SAMPLERS = Registry("sampler")
GROUPERS = Registry("grouper")
BACKENDS = Registry("backend")
FUSED_OPS = Registry("fused op")

register_sampler = SAMPLERS.register
register_grouper = GROUPERS.register
register_backend = BACKENDS.register
register_fused_op = FUSED_OPS.register


# ------------------------------------------------- builtin samplers -----

@register_sampler("fps")
def _fps_sampler(xyz: torch.Tensor, n_samples: int, lfsr_state,
                 shared: bool):
    """Farthest Point Sampling: data-dependent and stateless, so
    ``shared`` changes nothing and the LFSR state passes through."""
    from repro_torch.core import sampling
    return sampling.fps(xyz, n_samples), lfsr_state


#: A sampler that advances the LFSR state must run on every pass.
_fps_sampler.advances_state = False


@register_sampler("urs")
def _urs_sampler(xyz: torch.Tensor, n_samples: int, lfsr_state,
                 shared: bool):
    """LFSR-driven Uniform Random Sampling (HLS4PC §2.1).

    ``shared`` serves the whole batch from one index sequence (stream
    0), so a request's result is independent of its batch slot.
    """
    from repro_torch.core import sampling
    if lfsr_state is None:
        raise ValueError("the URS sampler needs an LFSR state")
    b, n = xyz.shape[0], xyz.shape[1]
    if shared:
        new_state, idx = sampling.urs_indices(lfsr_state, n, n_samples)
        idx = idx.to(xyz.device)[None, :].expand(b, n_samples)
        return idx, new_state
    new_state, idx = sampling.urs_indices_batched(lfsr_state, n, n_samples,
                                                  batch=b)
    return idx.to(xyz.device), new_state


#: A sampler that advances the LFSR state must run on every pass.
_urs_sampler.advances_state = True


# ------------------------------------------------- builtin groupers -----

@register_grouper("knn")
def _knn_grouper(xyz, feats, idx, k: int, affine_params, mode: str,
                 per_sample_norm: bool):
    """kNN group + geometric-affine normalize (HLS4PC §2.1, Fig. 2)."""
    from repro_torch.core import knn as knn_core
    return knn_core.group_points(xyz, feats, idx, k, affine_params, mode,
                                 per_sample_norm=per_sample_norm)


#: The ``ball`` grouper's radius.  The synthetic clouds live on
#: unit-scale surfaces, where 0.5 covers k <= 16 neighbours in dense
#: regions and clips far-side strays (``repro.api.registry``'s value);
#: register another radius with :func:`make_ball_grouper`.
DEFAULT_BALL_RADIUS = 0.5


def make_ball_grouper(radius: float):
    """A grouper doing ball query (radius + k cap) on the kNN kernel: the
    k nearest, each outside ``radius`` replaced by the nearest (PointNet++
    fill; ``radius=inf`` gives the ``knn`` entry's indices bit for bit).
    Register it under a key of its own for another radius::

        register_grouper("ball-0.2")(make_ball_grouper(0.2))
    """
    from repro_torch.core.knn import radius_sq
    radius_sq(radius)         # raises unless radius > 0 (NaN too)

    def ball_grouper(xyz, feats, idx, k: int, affine_params, mode: str,
                     per_sample_norm: bool):
        from repro_torch.core import knn as knn_core
        return knn_core.group_points(xyz, feats, idx, k, affine_params,
                                     mode, per_sample_norm=per_sample_norm,
                                     radius=radius)

    ball_grouper.radius = radius
    return ball_grouper


GROUPERS.register("ball")(make_ball_grouper(DEFAULT_BALL_RADIUS))


# ------------------------------------------------- builtin backends -----

@register_backend("ref")
def _cbr_ref(p, x, quant, act: bool):
    """Plain PyTorch CBR: ``layers.conv1d_apply`` then ReLU."""
    from repro_torch.models import layers as L
    y = L.conv1d_apply(p, x, quant=quant)
    return torch.relu(y) if act else y


@register_backend("cuda")
def _cbr_cuda(p, x, quant, act: bool):
    """CBR layers through the hand-written kernels.

    A frozen fp32 layer (2-D weight, BN folded, no quantization) runs the
    ``fused_linear`` kernel, bias and ReLU included.  An int8 export dict
    goes through the reference lowering, whose ``layers._matmul`` runs
    the int8 kernel for ``quant.backend == "int8_cuda"`` (bias and ReLU
    follow as tensor ops).  On CPU tensors every kernel wrapper runs its
    plain version.
    """
    w = p["w"]
    if (not isinstance(w, dict) and w.ndim == 2 and "bn" not in p
            and quant is None):
        from repro_torch.kernels import ops
        b = p.get("b")
        if b is None:
            b = torch.zeros(w.shape[1], dtype=w.dtype, device=w.device)
        return ops.fused_linear(x, w, b, "relu" if act else "none")
    return _cbr_ref(p, x, quant, act)


# ------------------------------------------------- builtin fused ops ----

@register_fused_op("grouped_transfer")
def _grouped_transfer(p, xyz, feats, idx, k: int, affine_params, mode: str,
                      per_sample_norm: bool, act: bool = True):
    """Fused gather + geometric-affine normalize + matmul+bias+ReLU.

    The lowering of a ``GroupOp`` + transfer ``CBROp`` pair: the kNN
    kernel, then one ``grouped_transfer`` kernel (its stats variant under
    per-cloud sigma) that never writes the ``[B, S, k, 2C]`` grouped
    tensor.  Needs a fused fp32 transfer layer (``spec.validate``
    enforces it).  On CPU tensors it runs the plain versions.
    """
    from repro_torch.kernels.grouped_transfer import fused_group_transfer
    return fused_group_transfer(xyz, feats, idx, k, affine_params, mode,
                                per_sample_norm, p, act=act)


def resolve(sampler: str, grouper: str, backend: str) -> tuple:
    """Resolve a spec's three registry keys to callables at once."""
    return SAMPLERS.get(sampler), GROUPERS.get(grouper), BACKENDS.get(backend)
