"""Model config of the LMs the port serves and trains, and the training recipe.

``repro.configs.base.ModelConfig``'s fields, with the JAX names, order
and defaults; ``quant`` is the port's own ``QuantConfig``.  ``remat``
checkpoints each layer of a training forward (``models/transformer.py``);
``unroll_layers`` is carried for the configs' sake (JAX reads it only
when it lowers the dry-run, and the port's layer loop is unrolled
already), and ``sharding_profile`` picks nothing on one device
(``models/moe.py``); ``seq_parallel=True`` raises
``NotImplementedError`` in the model.  ``ShapeConfig`` (the dry-run's
cells) is not ported.  :class:`TrainConfig` is
``repro.configs.base.TrainConfig``, field for field.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.quant import QuantConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture.  Families: dense | moe | vlm (the decoder),
    audio (the Whisper encoder-decoder), ssm (xLSTM), hybrid (Hymba)."""
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 0                 # encoder frames (stub frontend length)
    # --- SSM / hybrid ---
    ssm_state: int = 0
    conv_width: int = 4              # mamba short conv
    slstm_every: int = 0             # xLSTM: one sLSTM block every k layers
    # --- attention ---
    sliding_window: int = 0          # 0 = full attention
    rope_theta: float = 10000.0
    # --- frontend stubs: none | audio_stub ([B, enc_seq, d] float
    # frames) | patch_stub ([B, T, d] float inputs) ---
    frontend: str = "none"
    # --- numerics ---
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    remat: bool = True               # checkpoint each training layer
    unroll_layers: bool = False      # read by no ported path
    quant: QuantConfig = QuantConfig(w_bits=32, a_bits=32)
    # per-layer parallelism profile; picks nothing on one device
    sharding_profile: str = "default"
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
