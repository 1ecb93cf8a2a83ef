"""Model config of the decoder LMs the port serves, and the training recipe.

A subset of ``repro.configs.base.ModelConfig``: the fields the port's
dense LM reads, with the JAX names and defaults; ``quant`` is the port's
own ``QuantConfig``.  The JAX fields for MoE routing, the encoder, SSMs,
frontends, remat, layer unrolling and sharding profiles come with the
slices that read them (ROADMAP.md, Queue 1 item 7).  ``n_experts > 0``
and ``seq_parallel=True`` raise ``NotImplementedError`` in the model.
:class:`TrainConfig` is ``repro.configs.base.TrainConfig``, field for
field.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.quant import QuantConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture. The port serves ``family="dense"``."""
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    n_experts: int = 0               # > 0 (MoE) is not ported
    # --- attention ---
    sliding_window: int = 0          # 0 = full attention
    rope_theta: float = 10000.0
    # --- numerics ---
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    quant: QuantConfig = QuantConfig(w_bits=32, a_bits=32)
    # attention: xla (dense) | xla_chunked | flash (the CUDA kernel)
    attn_impl: str = "xla"
    seq_parallel: bool = False       # True is not ported

    @property
    def kv_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Paper recipe defaults (§3): SGD momentum=0.8, wd=2e-4, cosine LR
    0.1 -> 0.005, batch 256, (1000 epochs full-scale)."""
    optimizer: str = "sgd"
    lr: float = 0.1
    lr_min: float = 0.005
    momentum: float = 0.8
    weight_decay: float = 0.0002
    steps: int = 1000
    batch_size: int = 256
    microbatch: int = 0              # 0 = no grad accumulation
    seed: int = 0
    grad_compress_bits: int = 0      # 0=off, 8=int8 all-reduce (unported)
    checkpoint_every: int = 100
    checkpoint_dir: str = "checkpoints"
