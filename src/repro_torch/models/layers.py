"""Layers over plain parameter dicts (the JAX package's layout).

PointMLP's pointwise layers (with the QAT fake-quant matmul and the
training loss); the LMs' norms (RMSNorm, and Whisper's LayerNorm),
embeddings, RoPE, SwiGLU and tanh-GELU; and the k > 1 conv1d of
Whisper's audio frontend.

Matmul weights are ``[d_in, d_out]`` under ``"w"``; a weight may have
been replaced by an int8 export dict ``{"q", "scale"}``, and the apply
functions dispatch on that.

Under a ``model`` axis over processes a rank holds blocks of the LM's
weights (``sharding.rules``' ``default`` profile): ``gate``/``up`` are
column blocks and ``down`` a row block, whose partial products one
all-reduce sums (:func:`row_apply`, its bias added once after); the
embedding table is a vocab block, looked up masked and summed
(:func:`embedding_apply`).  ``group`` is that model group, None where
the rank holds the whole weight.  :class:`HeadSplit` splits a head-wise
layer (the attention's queries, the mLSTM, Hymba's SSM) by its heads.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.fusion import batchnorm_apply, batchnorm_init
from repro_torch.core.quant import (QuantConfig, fake_quant_act,
                                    fake_quant_weight)
from repro_torch.kernels.ref import matmul
from repro_torch.sharding import collectives as C
from repro_torch.tree import tree_map


def _normal(generator: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=generator,
                       device=generator.device) * std


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               bias: bool = True, scale: Optional[float] = None,
               dtype=torch.float32) -> Dict:
    std = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": _normal(generator, (d_in, d_out), std).to(dtype)}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=dtype, device=generator.device)
    return p


def conv1d_init(generator: torch.Generator, c_in: int, c_out: int,
                ksize: int = 1, bias: bool = True, bn: bool = False,
                dtype=torch.float32) -> Dict:
    """A conv1d, N(0, 1/(c_in * ksize)) like ``repro.models.layers.
    conv1d_init``: weight [c_in, c_out] when pointwise (PointMLP's
    layers), else [ksize, c_in, c_out] (Whisper's frontend)."""
    shape = (c_in, c_out) if ksize == 1 else (ksize, c_in, c_out)
    p = {"w": _normal(generator, shape,
                      1.0 / math.sqrt(c_in * ksize)).to(dtype)}
    if bias:
        p["b"] = torch.zeros(c_out, dtype=dtype, device=generator.device)
    if bn:
        p["bn"] = batchnorm_init(c_out, generator.device)
    return p


def _matmul(x: torch.Tensor, w, quant: Optional[QuantConfig]
            ) -> torch.Tensor:
    """Dispatch: fp32 matmul, W8 dequantized matmul, the W8A8 kernel, or
    (a float weight under an enabled ``quant``) the QAT fake-quant matmul:
    the weight per out-channel and the activation per tensor, rounded to
    their grids with a straight-through gradient, then the plain
    product."""
    if isinstance(w, dict):                  # int8 export {"q", "scale"}
        backend = quant.backend if quant is not None else "int8_ref"
        if backend == "int8_cuda":
            from repro_torch.kernels import ops
            lanes = x.shape[0] if quant.per_lane else 1
            return ops.int8_matmul(x, w["q"], w["scale"], a_bits=quant.a_bits,
                                   lanes=lanes, tile=quant.tiles)
        # W8 reference path: dequantized weight matmul.
        return matmul(x, w["q"].to(x.dtype) * w["scale"].to(x.dtype))
    if quant is not None and quant.enabled:
        w = fake_quant_weight(w, quant)
        x = fake_quant_act(x, quant)
    return matmul(x, w.to(x.dtype))


@contextlib.contextmanager
def f32_sums():
    """Within the block, cuBLAS sums bf16 products in f32, as XLA's dot
    does (PyTorch's default lets it reduce them in bf16), and multiplies
    f32 operands in f32, not TF32 (the MoE router).  The flags are
    process-wide; they are restored on exit."""
    m = torch.backends.cuda.matmul
    saved = m.allow_bf16_reduced_precision_reduction, m.allow_tf32
    m.allow_bf16_reduced_precision_reduction = False
    m.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_bf16_reduced_precision_reduction, m.allow_tf32 = saved


def dense_apply(p: Dict, x: torch.Tensor,
                quant: Optional[QuantConfig] = None) -> torch.Tensor:
    y = _matmul(x, p["w"], quant)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def conv1d_apply(p: Dict, x: torch.Tensor, stride: int = 1,
                 quant: Optional[QuantConfig] = None,
                 bn_eps: float = 1e-5) -> torch.Tensor:
    """x [..., T, C_in] -> [..., T', C_out].  Pointwise: the (possibly
    int8) product, every ``stride``-th row kept.  ksize > 1 (x [T, C_in]
    or [B, T, C_in]): XLA's ``padding="SAME"``, which pads ``pad // 2``
    before and the rest after (uneven at stride 2; ``F.conv1d``'s own
    padding is even), x cast to the weight's dtype.  An unfused BN runs
    in inference mode after the conv."""
    w = p["w"]
    if isinstance(w, dict) or w.ndim == 2:
        y = _matmul(x, w, quant)
        if stride > 1:
            y = y[..., ::stride, :]
    else:
        lhs = (x[None] if x.ndim == 2 else x).to(w.dtype).transpose(1, 2)
        ksize, t = w.shape[0], lhs.shape[-1]
        pad = max((-(-t // stride) - 1) * stride + ksize - t, 0)
        lhs = F.pad(lhs, (pad // 2, pad - pad // 2))
        y = F.conv1d(lhs, w.permute(2, 1, 0), stride=stride).transpose(1, 2)
        if x.ndim == 2:
            y = y[0]
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    if "bn" in p:
        y = batchnorm_apply(y, p["bn"], bn_eps)
    return y


# ------------------------------------------------ decoder LM layers -----
# Each op keeps its JAX counterpart's order of roundings
# (``repro.models.layers``); inits draw from an explicit generator in f32
# and cast to the config's dtype, as the JAX inits do.

def rmsnorm_init(d: int, dtype=torch.float32, device=None) -> Dict:
    return {"g": torch.ones(d, dtype=dtype, device=device)}


def rmsnorm_apply(p: Dict, x: torch.Tensor, eps: float = 1e-5
                  ) -> torch.Tensor:
    """f32 mean of squares and rsqrt, the normalized x cast to x.dtype,
    then times g in x.dtype."""
    x32 = x.float()
    inv = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * inv).to(x.dtype) * p["g"].to(x.dtype)


def layernorm_init(d: int, dtype=torch.float32, device=None) -> Dict:
    return {"g": torch.ones(d, dtype=dtype, device=device),
            "b": torch.zeros(d, dtype=dtype, device=device)}


def layernorm_apply(p: Dict, x: torch.Tensor, eps: float = 1e-5
                    ) -> torch.Tensor:
    """f32 mean, population variance (the mean of squared deviations) and
    rsqrt, the normalized x cast to x.dtype, then the affine in x.dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    c = x32 - mu
    y = c * torch.rsqrt((c * c).mean(dim=-1, keepdim=True) + eps)
    return y.to(x.dtype) * p["g"].to(x.dtype) + p["b"].to(x.dtype)


def embedding_init(generator: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32) -> Dict:
    return {"table": _normal(generator, (vocab, d), 0.02).to(dtype)}


def embedding_apply(p: Dict, ids: torch.Tensor, vocab: int = 0
                    ) -> torch.Tensor:
    """The rows of ``ids``.  Where this rank holds a vocab block of a
    ``vocab``-row table, the rows in its block (zeros elsewhere), summed
    over the model group: exactly one rank adds each row, so it is the
    whole table's lookup bit for bit."""
    table = p["table"]
    group = C.split_group(table.shape[0], vocab or table.shape[0],
                          "embedding table")
    if group is None:
        return table[ids]
    n = table.shape[0]
    local = ids - C.group_rank(group) * n
    hit = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    return C.reduce_from(torch.where(hit[..., None], rows,
                                     rows.new_zeros(())), group)


def unembed_apply(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: logits = x @ table.T in f32."""
    return x.float() @ p["table"].float().T


def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x [..., T, D]; positions broadcastable to [..., T].  f32 angles,
    split-halves rotation, cast back to x.dtype."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)               # [D/2]
    angles = positions[..., None].float() * freqs               # [..., T, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x).  On the CPU, sigmoid is ``1 / (1 + exp(-x))`` with
    each op rounded in x.dtype: ``jax.nn.sigmoid`` is XLA's ``logistic``,
    which the CPU backend expands so (bitwise in bf16, where
    ``torch.sigmoid`` rounds once and differs in about a third of
    values).  On the card, where nothing is held bitwise against XLA, it
    is one ``F.silu`` pass (f32 inside, rounded once) in place of five;
    meta tensors (the dry-run's) take the card's form, so a dry-run
    counts the card's program."""
    if x.device.type != "cpu":
        return F.silu(x)
    return x * (1 / (1 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (``F.gelu``'s
    default is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                          ) -> torch.Tensor:
    """logits [..., V], labels [...] int -> scalar mean loss in f32:
    ``mean(logsumexp(logits) - logits[label])``, as
    ``repro.models.layers.softmax_cross_entropy``."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.to(torch.int64)[..., None])[..., 0]
    return (lse - ll).mean()


def swiglu_init(generator: torch.Generator, d: int, d_ff: int,
                dtype=torch.float32) -> Dict:
    return {"gate": dense_init(generator, d, d_ff, bias=False, dtype=dtype),
            "up": dense_init(generator, d, d_ff, bias=False, dtype=dtype),
            "down": dense_init(generator, d_ff, d, bias=False, dtype=dtype)}


def out_features(p: Dict) -> int:
    """A dense layer's output width as this rank holds it (a float ``w``
    or its int8 export)."""
    w = p["w"]
    return (w["q"] if isinstance(w, dict) else w).shape[-1]


def in_features(p: Dict) -> int:
    w = p["w"]
    return (w["q"] if isinstance(w, dict) else w).shape[-2]


def whole_grad(p, group):
    """A whole leaf (or tree of them) that this rank reads only in part
    (its heads' slice, its sequence block): itself, its gradient summed
    over ``group``."""
    return tree_map(lambda t: C.copy_to(t, group), p) if group is not None \
        else p


def dense_block(p: Dict, dim: int, start: int, size: int) -> Dict:
    """A block of a dense layer's weight (a float ``w`` or its int8 export
    ``{q, scale}``): columns for ``dim`` -1 (the scale's and bias's too),
    rows for -2 (the scale and bias whole, as :func:`row_apply` adds the
    bias once)."""
    def cols(t):
        return t.narrow(-1, start, size) if dim == -1 else t
    w = p["w"]
    if isinstance(w, dict):
        w = {"q": w["q"].narrow(dim, start, size), "scale": cols(w["scale"])}
    else:
        w = w.narrow(dim, start, size)
    out = dict(p, w=w)
    if "b" in p:
        out["b"] = cols(p["b"])
    return out


def row_apply(p: Dict, x: torch.Tensor, quant: Optional[QuantConfig] = None,
              group=None) -> torch.Tensor:
    """:func:`dense_apply` of a row block (``x`` holds the matching
    columns): the partial products summed over ``group`` (in f32 for a
    16-bit dtype, rounded once), then the bias, once."""
    if group is None:
        return dense_apply(p, x, quant)
    y = C.reduce_from(_matmul(x, p["w"], quant), group)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def swiglu_apply(p: Dict, x: torch.Tensor,
                 quant: Optional[QuantConfig] = None, group=None
                 ) -> torch.Tensor:
    """SwiGLU; ``group`` the model group ``gate``/``up`` (column blocks)
    and ``down`` (a row block) are split over."""
    x = C.copy_to(x, group)
    g = dense_apply(p["gate"], x, quant)
    u = dense_apply(p["up"], x, quant)
    return row_apply(p["down"], silu(g) * u, quant, group)


def layer_group(*held, what: str):
    """The ``model`` group a layer's weights split over: the first of
    ``held``'s ``(local, whole)`` widths that a rank holds a block of
    (``collectives.split_group``), None where it holds every one
    whole."""
    for local, whole in held:
        group = C.split_group(local, whole, what)
        if group is not None:
            return group
    return None


class HeadSplit:
    """This rank's share of a head-wise layer of ``heads`` heads whose
    column weights (``[d_in, heads * width]``) and row weight (``[heads *
    width, d_out]``) are blocks over ``group`` (None: a whole layer).

    Where the heads divide over the group (``even``) the rank computes
    its own heads ``[lo, lo + n)``: a column block is its heads'
    columns; a whole leaf (a gate or decay projection, a depthwise conv,
    a per-head norm or skip) is read in its heads' slice, its gradient
    summed over the group (:func:`whole_grad`); the row product's
    partial outputs are summed.  Where they do not (a column block cuts
    a head), every rank gathers every head and computes the whole layer
    alike (``n`` = ``heads``), then feeds the row weight its own rows
    (``collectives.split_to``, whose backward gathers the gradient, so
    the whole leaves' gradients are whole on every rank).  The layer's
    input is read through :meth:`input` for the column products."""

    def __init__(self, heads: int, group):
        m, r = C.group_size(group), C.group_rank(group)
        self.group, self.heads = group, heads
        self.even = group is not None and heads % m == 0
        self.lo, self.n = (r * heads // m, heads // m) if self.even \
            else (0, heads)

    def input(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the column blocks read it (their gradients summed)."""
        return C.copy_to(x, self.group)

    def cols(self, p: Dict, x: torch.Tensor, xc: torch.Tensor, width: int,
             quant: Optional[QuantConfig] = None) -> torch.Tensor:
        """The columns of ``x @ w (+ b)`` of this rank's heads (every head
        where they split unevenly), each head ``width`` wide; ``xc`` is
        :meth:`input` of ``x``."""
        if out_features(p) == self.heads * width:          # a whole leaf
            if not self.even:
                return dense_apply(p, x, quant)
            y = dense_apply(whole_grad(p, self.group), xc, quant)
            return y.narrow(-1, self.lo * width, self.n * width)
        y = dense_apply(p, xc, quant)
        return y if self.even else C.gather_from(y, -1, self.group)

    def take(self, t: torch.Tensor, dim: int, width: int) -> torch.Tensor:
        """A whole leaf's slice of this rank's heads along ``dim``."""
        if not self.even:
            return t
        return whole_grad(t, self.group).narrow(dim, self.lo * width,
                                                self.n * width)

    def out(self, p: Dict, y: torch.Tensor,
            quant: Optional[QuantConfig] = None) -> torch.Tensor:
        """The row product of ``y`` (this rank's heads' columns, or every
        head's), whole on every rank."""
        if self.even:
            return row_apply(p, y, quant, self.group)
        if in_features(p) == y.shape[-1]:                  # a whole leaf
            return dense_apply(p, y, quant)
        return row_apply(p, C.split_to(y, -1, self.group), quant,
                         self.group)
