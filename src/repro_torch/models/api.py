"""Model API: one dispatch surface over all families, as ``repro.models.api``.

``get_model(cfg)`` -> :class:`ModelAPI` with ``init``, ``loss_fn``,
``forward``, ``init_cache``, ``prefill`` and ``decode_step``, for every
family: the decoder (``family`` dense, moe and vlm; JAX's
``_decoder_lm``), the Whisper encoder-decoder (``audio``;
``_encdec_lm``), xLSTM (``ssm``; ``_xlstm_lm``) and Hymba (``hybrid``;
``_hymba_lm``).  ``loss_fn(params, batch)`` -> (loss, metrics): for the
decoder ``transformer.lm_loss``; for xLSTM, Hymba and Whisper the
forward's mean cross-entropy over the f32 logits (metrics ``loss``,
``ce``, ``moe_aux``; the aux is the forward's zero), as JAX's
``_xlstm_lm``, ``_hymba_lm`` and ``_encdec_lm``; each trains through
``train.train_loop``, with ``cfg.remat`` checkpointing the layers JAX
checkpoints.  ``batch`` holds
``"tokens"`` ([B, T] ids, or for the VLM float [B, T, d] stub
embeddings) and ``"labels"``; for ``audio`` also ``"frames"`` (float [B,
enc_seq, d] stub embeddings), and its ``forward`` takes that dict, as
JAX's does.  ``input_specs(shape)`` gives a cell's step inputs as
:class:`TensorSpec` (shape, dtype) stand-ins, JAX's ``ShapeDtypeStruct``
dtypes included (int32 tokens and labels, f32 ``frames`` and VLM
embeddings; a decode step's ``token [B]`` and ``pos []``); the dry-run
makes fake tensors of them.  ``init`` and ``init_cache`` put their
tensors on ``cuda`` unless given a device, and raise without a GPU.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.api.build import resolve_device, to_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec as E
from repro_torch.models import hymba as HY
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as X


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable          # (generator, device=None) -> params
    loss_fn: Callable       # (params, batch) -> (loss, metrics)
    forward: Callable       # (params, inputs) -> (logits, aux)
    init_cache: Callable    # (batch, max_len, device=None) -> cache
    prefill: Callable       # (params, batch, cache) -> (logits, cache)
    decode_step: Callable   # (params, batch, cache) -> (logits, cache)
    input_specs: Callable   # (shape_cfg) -> dict of TensorSpec


class TensorSpec(NamedTuple):
    """A tensor's shape and dtype, no values (``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


DECODER_FAMILIES = ("dense", "moe", "vlm")


def _input_specs(cfg: ModelConfig, shape: ShapeConfig
                 ) -> Dict[str, TensorSpec]:
    """A cell's step inputs: ``tokens`` (f32 [B, T, d] stub embeddings
    for the VLM) and, to train, ``labels``; Whisper's ``frames`` [B,
    enc_seq, d] f32 beside them; a decode step's ``token`` [B] and
    ``pos`` []."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"token": TensorSpec((b,), torch.int32),
                "pos": TensorSpec((), torch.int32)}
    tok = TensorSpec((b, s), torch.int32)
    out = {"tokens": (TensorSpec((b, s, cfg.d_model), torch.float32)
                      if cfg.frontend == "patch_stub" else tok)}
    if cfg.family == "audio":
        out = {"frames": TensorSpec((b, cfg.enc_seq, cfg.d_model),
                                    torch.float32), **out}
    if shape.kind == "train":
        out["labels"] = tok
    return out


def _api(cfg: ModelConfig, init_fn: Callable, cache_fn: Callable,
         forward: Callable, prefill: Callable, decode: Callable,
         loss_fn: Callable = None) -> ModelAPI:
    """A ModelAPI from a family's functions: ``init_fn(generator, cfg)``,
    ``cache_fn(cfg, batch, max_len, device=)``, ``forward(params,
    inputs)``, ``prefill(params, batch, cache)``, ``decode(params, token,
    pos, cache)``; without ``loss_fn``, the forward's mean
    cross-entropy."""
    def init(generator: torch.Generator, device=None):
        dev = resolve_device(device)
        return to_device(init_fn(generator, cfg), dev)

    def init_cache(batch: int, max_len: int, device=None):
        return cache_fn(cfg, batch, max_len, device=resolve_device(device))

    def ce_loss(params, batch):
        logits, aux = forward(params, batch if cfg.family == "audio"
                              else batch["tokens"])
        ce = L.softmax_cross_entropy(logits, batch["labels"])
        return ce, {"loss": ce, "ce": ce, "moe_aux": aux}

    return ModelAPI(
        cfg=cfg, init=init, loss_fn=loss_fn or ce_loss, forward=forward,
        init_cache=init_cache, prefill=prefill,
        decode_step=lambda p, batch, c: decode(p, batch["token"],
                                               batch["pos"], c),
        input_specs=lambda shape: _input_specs(cfg, shape))


def get_model(cfg: ModelConfig) -> ModelAPI:
    fam = cfg.family
    if fam in DECODER_FAMILIES:
        return _api(
            cfg, T.lm_init, T.lm_init_cache,
            lambda p, x: T.lm_forward(p, cfg, x),
            lambda p, batch, c: T.lm_prefill(p, cfg, batch["tokens"], c),
            lambda p, tok, pos, c: T.lm_decode_step(p, cfg, tok, pos, c),
            loss_fn=lambda p, batch: T.lm_loss(p, cfg, batch))
    if fam == "audio":
        return _api(
            cfg, E.encdec_init, E.encdec_init_cache,
            lambda p, batch: E.encdec_forward(p, cfg, batch["frames"],
                                              batch["tokens"]),
            lambda p, batch, c: E.encdec_prefill(p, cfg, batch["frames"],
                                                 batch["tokens"], c),
            lambda p, tok, pos, c: E.encdec_decode_step(p, cfg, tok, pos, c))
    if fam == "ssm":
        return _api(
            cfg, X.xlstm_init, X.xlstm_init_cache,
            lambda p, x: X.xlstm_forward(p, cfg, x),
            lambda p, batch, c: X.xlstm_prefill(p, cfg, batch["tokens"], c),
            lambda p, tok, pos, c: X.xlstm_decode_step(p, cfg, tok, pos, c))
    if fam == "hybrid":
        return _api(
            cfg, HY.hymba_init, HY.hymba_cache_init,
            lambda p, x: HY.hymba_forward(p, cfg, x),
            lambda p, batch, c: HY.hymba_prefill(p, cfg, batch["tokens"], c),
            lambda p, tok, pos, c: HY.hymba_decode_step(p, cfg, tok, pos,
                                                        c))
    raise ValueError(f"unknown family {fam}")
