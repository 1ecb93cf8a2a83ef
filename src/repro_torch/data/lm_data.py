"""Synthetic LM token stream, deterministic in (seed, step, host), drawn with numpy.

The port of ``repro.data.lm_data``: no text corpus ships with the repo,
so LM training runs on a Zipf-distributed stream in which every position
copies the previous token with probability 0.3 (a signal a model can
learn).  JAX draws with ``jax.random``; the port draws with numpy, keyed
by ``np.random.SeedSequence([seed, step, host_id])``, so a batch is a
pure function of (seed, step, host) and a resumed or replaced host sees
exactly the batches it owes.  The two packages' draws differ; what they
make of them does not: :func:`tokens_from_draws` is JAX's ``synth_batch``
as a function of its uniform and Bernoulli draws, so a test can feed it
JAX's own.

Every batch is made on the host and then moved to ``device`` (``cuda``
unless the caller asks for the CPU), so the CPU and the card see the
same ids.  Ids are int64, torch's index type.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

COPY_PROB = 0.3
U_MIN = 1e-6              # the uniform draw's lower end, as in JAX

_F32 = np.float32
# Cephes's expf: 2**n split of the argument, then a degree-5 polynomial.
_LOG2E, _LN2_HI, _LN2_LO = _F32(1.44269504088896341), _F32(0.693359375),     _F32(-2.12194440e-4)
_EXP_POLY = tuple(_F32(c) for c in (1.9875691500e-4, 1.3981999507e-3,
                                    8.3334519073e-3, 4.1665795894e-2,
                                    1.6666665459e-1, 5.0000001201e-1))


def _fma(a, b, c) -> np.ndarray:
    """``a * b + c`` of float32s rounded once (the product is exact in
    float64)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(_F32)


def exp_f32(x: np.ndarray) -> np.ndarray:
    """float32 ``exp`` as XLA's CPU backend computes it: Cephes's
    polynomial with fused multiply-adds.  numpy's own float32 ``exp``
    differs from it by an ulp in about 40% of values, enough to move a
    few ids in 10**4 across an integer."""
    x = np.clip(np.asarray(x, _F32), _F32(-88.3762626647950),
                _F32(88.3762626647949))
    n = np.floor(_fma(x, _LOG2E, _F32(0.5)))
    r = _fma(-n, _LN2_HI, x)
    r = _fma(-n, _LN2_LO, r)
    y = np.full_like(r, _EXP_POLY[0])
    for c in _EXP_POLY[1:]:
        y = _fma(y, r, c)
    y = _fma(y, r * r, r) + _F32(1.0)
    return y * ((n.astype(np.int32) + 127) << 23).view(_F32)


def tokens_from_draws(u: np.ndarray, copy: np.ndarray, vocab: int
                      ) -> np.ndarray:
    """Token ids [B, T+1] int32 from uniform draws ``u`` in [1e-6, 1)
    and Bernoulli ``copy`` flags, both [B, T+1]: the Zipf-ish rank
    ``exp(u * log V) - 1`` in float32 (:func:`exp_f32`), truncated to
    int32 and clipped to [0, V), then each flagged position takes its
    left neighbour's id (position 0 the last one's: JAX's ``roll``)."""
    u = np.asarray(u, _F32)
    ranks = exp_f32(u * _F32(np.log(float(vocab)))) - _F32(1.0)
    toks = np.clip(ranks.astype(np.int32), 0, vocab - 1)
    return np.where(np.asarray(copy, bool), np.roll(toks, 1, axis=1), toks)


def synth_batch(seed: int, step: int, batch: int, seq_len: int, vocab: int,
                host_id: int = 0, device=None) -> Dict[str, torch.Tensor]:
    """Batch ``step`` of the stream of ``seed`` for host ``host_id``:
    ``{"tokens": [B, T], "labels": [B, T]}`` int64 on ``device`` (default
    ``cuda``; raises without a GPU), the labels the tokens shifted left
    by one."""
    from repro_torch.api.build import resolve_device
    dev = resolve_device(device)
    rng = np.random.default_rng(np.random.SeedSequence([seed, step,
                                                        host_id]))
    shape = (batch, seq_len + 1)
    u = np.maximum(_F32(U_MIN), _F32(U_MIN) + _F32(1 - U_MIN)
                   * rng.random(shape, _F32))
    copy = rng.random(shape) < COPY_PROB
    toks = torch.from_numpy(tokens_from_draws(u, copy, vocab).astype(
        np.int64))
    return {"tokens": toks[:, :-1].contiguous().to(dev),
            "labels": toks[:, 1:].contiguous().to(dev)}


def stream(seed: int, batch: int, seq_len: int, vocab: int,
           start_step: int = 0, host_id: int = 0, device=None
           ) -> Iterator[Dict[str, torch.Tensor]]:
    """The infinite stream of :func:`synth_batch` batches from
    ``start_step`` on: a run resumed at step s sees the batches an
    uninterrupted run saw from s."""
    step = start_step
    while True:
        yield synth_batch(seed, step, batch, seq_len, vocab, host_id, device)
        step += 1
