"""Fused linear + bias + activation: the CUDA kernel ``csrc/fused_linear.cu``.

The port of ``repro.kernels.fused_linear.fused_linear_pallas``:
``act(x @ w + b)`` in full fp32 (no TF32), one launch per layer per
dispatch.  ``fused_linear_cuda.launches`` counts launches and
``.templates`` the launches of each template by name; :func:`template`
names the template of ``csrc/fused_linear.cu`` that a product takes,
by the wrapper's rule or as a ``KernelTuning`` tile pins it.
"""
from __future__ import annotations

import collections
import functools

import torch

from repro_torch.kernels import _build, tuning
from repro_torch.kernels.ref import ACTIVATIONS

# csrc/fused_linear.cu's act codes.
_ACT_CODE = {"none": 0, "relu": 1, "gelu": 2}
H100_SMS = 132


def template(m: int, k: int, n: int, aligned: bool = True,
             sms: int = H100_SMS, tile=None) -> _build.GemmTemplate:
    """The template of ``csrc/fused_linear.cu`` for ``[M, K] @ [K, N]``.

    The column tile follows N, with 128 rows a block, or 256 at BN <= 32;
    where that gives at most one block for two of the card's SMs
    (``sms``), the small tile (BN 16 or 32, one row and 4 columns a
    thread) spreads the product wider.  16-byte copies and stores
    (``vec``) need 16-byte aligned operands, K % 4 == 0 and N % 4 == 0.
    A ``tile`` (BM, BK, BN) pins one template instead
    (``kernels.tuning.FUSED_LINEAR_TILES``); ``vec`` still follows the
    operands.
    """
    vec = aligned and k % 4 == 0 and n % 4 == 0
    if tile is not None:
        bn, small = tuning.card_tile("fused_linear", tile)
        return _build.GemmTemplate(bn, vec, small)
    wide = _build.gemm_template(n, vec)
    rows = 256 if wide.bn <= 32 else 128
    if 2 * -(-m // rows) * -(-n // wide.bn) > sms:
        return wide
    return _build.GemmTemplate(16 if n <= 16 else 32, wide.vec, small=True)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def fused_linear_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      activation: str = "relu", tile=None) -> torch.Tensor:
    """Launch the kernel: x f32 [M, K], w f32 [K, N], b f32 [N] -> [M, N],
    on the template :func:`template` names (``tile`` pins one)."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {ACTIVATIONS}, "
                         f"got {activation!r}")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"fused_linear: x [M, K] @ w [K, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if b.shape != (w.shape[1],):
        raise ValueError(f"fused_linear: bias must be [{w.shape[1]}], "
                         f"got {tuple(b.shape)}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if (not t.is_cuda or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != x.device):
            raise ValueError(f"fused_linear kernel needs contiguous float32 "
                             f"CUDA tensors on one device; {name} is "
                             f"{t.dtype} on {t.device}")
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m * n == 0:
        return out
    tmpl = template(m, k, n, _build.aligned16(x, w),
                    _sm_count(x.device.index), tile)
    _build.launch("fused_linear", x.device, x.data_ptr(), w.data_ptr(),
                  b.data_ptr(), out.data_ptr(), m, k, n,
                  _ACT_CODE[activation], tmpl.code)
    fused_linear_cuda.launches += 1
    fused_linear_cuda.templates[tmpl.name] += 1
    return out


fused_linear_cuda.launches = 0
fused_linear_cuda.templates = collections.Counter()
