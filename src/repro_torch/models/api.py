"""Model API of the decoder LM: one dispatch surface, as ``repro.models.api``.

``get_model(cfg)`` -> :class:`ModelAPI` with ``init``, ``loss_fn``,
``forward``, ``init_cache``, ``prefill`` and ``decode_step``, for the
decoder family (``family`` dense, moe and vlm; JAX's ``_decoder_lm``).
``loss_fn(params, batch)`` is ``transformer.lm_loss``: ``batch`` holds
``"tokens"`` ([B, T] ids, or for the VLM float [B, T, d] stub
embeddings) and ``"labels"`` ([B, T] ids).  The encoder-decoder, SSM
and hybrid families (``audio``, ``ssm``, ``hybrid``) wait for
ROADMAP.md Queue 1 item 7; ``input_specs`` (JAX ``ShapeDtypeStruct``
stand-ins for the dry-run) has no counterpart.
``init`` and ``init_cache`` put their tensors on ``cuda`` unless given a
device, and raise without a GPU.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.api.build import resolve_device, to_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable          # (generator, device=None) -> params
    loss_fn: Callable       # (params, batch) -> (loss, metrics)
    forward: Callable       # (params, inputs) -> (logits, aux)
    init_cache: Callable    # (batch, max_len, device=None) -> cache
    prefill: Callable       # (params, batch, cache) -> (logits, cache)
    decode_step: Callable   # (params, batch, cache) -> (logits, cache)


DECODER_FAMILIES = ("dense", "moe", "vlm")


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family in ("audio", "ssm", "hybrid"):
        raise NotImplementedError(
            f"family {cfg.family!r} waits for Queue 1 item 7 (the LM side) "
            f"in ROADMAP.md; the port serves {DECODER_FAMILIES}")
    if cfg.family not in DECODER_FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")

    def init(generator: torch.Generator, device=None):
        dev = resolve_device(device)
        return to_device(T.lm_init(generator, cfg), dev)

    def init_cache(batch: int, max_len: int, device=None):
        return T.lm_init_cache(cfg, batch, max_len,
                               device=resolve_device(device))

    return ModelAPI(
        cfg=cfg,
        init=init,
        loss_fn=lambda p, batch: T.lm_loss(p, cfg, batch),
        forward=lambda p, x: T.lm_forward(p, cfg, x),
        init_cache=init_cache,
        prefill=lambda p, batch, c: T.lm_prefill(p, cfg, batch["tokens"], c),
        decode_step=lambda p, batch, c: T.lm_decode_step(
            p, cfg, batch["token"], batch["pos"], c))
