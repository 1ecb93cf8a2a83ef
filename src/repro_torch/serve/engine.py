"""Batched LM serving engine: prefill once, then greedy (or sampled)
decode over a KV cache (``repro.serve.engine``'s port).

Times are host clocks around work that ends in ``torch.cuda.synchronize``
(JAX's ``block_until_ready``).  Greedy decoding (``temperature=0``, the
default) takes ``argmax``, the first index on ties, as ``jnp.argmax``.
Temperature sampling draws from a ``torch.Generator`` seeded from
``seed``; it does not reproduce ``jax.random``'s draws.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import torch

from repro_torch.api.build import resolve_device
from repro_torch.models.api import ModelAPI


def holds_positions(cfg) -> bool:
    """Whether the model's cache holds one slot per position (a dense KV
    cache), so that ``max_len`` bounds a generation: not xLSTM's O(1)
    state (``family`` ssm), not a rolling window cache."""
    return cfg.family != "ssm" and cfg.sliding_window == 0


@dataclasses.dataclass
class ServeStats:
    prefill_s: float
    decode_s: float
    tokens_out: int

    @property
    def decode_tok_per_s(self) -> float:
        return self.tokens_out / max(self.decode_s, 1e-9)


class Engine:
    """Serves ``api`` with ``params`` (already on ``device``; ``cuda``
    unless given, raising without a GPU)."""

    def __init__(self, api: ModelAPI, params, max_len: int,
                 batch_size: int, temperature: float = 0.0, seed: int = 0,
                 device=None):
        self.api = api
        self.params = params
        self.max_len = max_len
        self.batch = batch_size
        self.temperature = temperature
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0]

    def generate(self, batch: Dict[str, torch.Tensor], n_tokens: int
                 ) -> Dict[str, object]:
        """batch: the prefill inputs, passed whole to ``api.prefill`` (as
        JAX's engine does): {"tokens": [B, S] ids, or [B, S, d] float
        stub embeddings (the VLM patch stub; decode feeds ids)}, and for
        the encoder-decoder "frames" [B, enc_seq, d].  Returns the
        generated ids [B, n_tokens], the last decode step's logits [B, V]
        and stats.

        Where the cache holds positions (a dense KV cache of ``max_len``),
        a prompt plus ``n_tokens`` decode steps that do not fit raise
        ``ValueError`` (JAX would clamp the cache writes silently).  A
        rolling window cache and xLSTM's recurrent state hold no
        positions, and generate past ``max_len``, as in JAX.
        """
        batch = {k: v.to(self.device) for k, v in batch.items()}
        b, prompt_len = batch["tokens"].shape[:2]
        if holds_positions(self.api.cfg) and \
                prompt_len + n_tokens > self.max_len:
            raise ValueError(f"a prompt of {prompt_len} and {n_tokens} decode "
                             f"steps need a cache of {prompt_len + n_tokens} "
                             f"positions; max_len is {self.max_len}")
        cache = self.api.init_cache(b, self.max_len, self.device)
        self._sync()
        t0 = time.perf_counter()
        logits, cache = self.api.prefill(self.params, batch, cache)
        self._sync()
        t_prefill = time.perf_counter() - t0

        out: List[torch.Tensor] = []
        tok = self._sample(logits)
        t0 = time.perf_counter()
        for i in range(n_tokens):
            out.append(tok)
            logits, cache = self.api.decode_step(
                self.params, {"token": tok, "pos": prompt_len + i}, cache)
            tok = self._sample(logits)
        self._sync()
        t_decode = time.perf_counter() - t0
        return {"ids": torch.stack(out, dim=1), "logits": logits,
                "stats": ServeStats(prefill_s=t_prefill, decode_s=t_decode,
                                    tokens_out=b * n_tokens)}
