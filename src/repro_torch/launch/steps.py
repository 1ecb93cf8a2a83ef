"""The train, prefill and decode steps of a model API, on one device.

The port of ``repro.launch.steps``.  JAX's step functions take a mesh and
pass every batch leaf through ``rules.constrain_batch``, a sharding
constraint that is a no-op on one device; the port's take no mesh.  A
sharding ``profile`` other than ``"default"`` waits for the sharded part
of ROADMAP.md Queue 1 item 4.  ``shape_trees`` and ``cell_shardings``
(the abstract trees and shardings the dry-run lowers) wait for the
dry-run bullet of Queue 1 item 7.  :func:`build_train_step` takes
every family: the decoders, xLSTM, Hymba and Whisper (whose batches
carry ``"frames"`` beside ``"tokens"`` and ``"labels"``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import TrainConfig
from repro_torch.train.train_loop import build_accumulating_step


def _check_profile(profile: str) -> None:
    if profile != "default":
        raise NotImplementedError(
            f"sharding profile {profile!r} waits for Queue 1 item 4 (the "
            f"sharded part) in ROADMAP.md; one device takes 'default'")


def build_train_step(api, train_cfg: TrainConfig, profile: str = "default"):
    """(train_step, init_opt).  ``train_step(params, opt_state, batch,
    step)`` -> (params, opt_state, metrics): the loss and its gradient
    (``api.loss_fn``), the gradients clipped to global norm 1, then the
    optimizer's update at ``cosine_lr(step)``; the metrics are the
    loss's plus ``grad_norm`` and ``lr``.  It is
    ``train.train_loop.build_accumulating_step`` without microbatches,
    and takes every family ``models.api.get_model`` serves."""
    _check_profile(profile)
    return build_accumulating_step(
        api, dataclasses.replace(train_cfg, microbatch=0))


def build_prefill_step(api, profile: str = "default"):
    """``prefill_step(params, batch, cache)`` -> (last-position logits,
    cache): ``api.prefill``."""
    _check_profile(profile)

    def prefill_step(params, batch, cache):
        return api.prefill(params, batch, cache)
    return prefill_step


def build_decode_step(api):
    """``serve_step(params, batch, cache)`` -> (logits, cache):
    ``api.decode_step``."""
    def serve_step(params, batch, cache):
        return api.decode_step(params, batch, cache)
    return serve_step
