"""Model config of the LMs, the dry-run's shape cells and the training recipe.

``repro.configs.base.ModelConfig``'s fields, with the JAX names, order
and defaults; ``quant`` is the port's own ``QuantConfig``.  ``remat``
checkpoints each layer of a training forward (``models/transformer.py``);
``unroll_layers`` is carried for the configs' sake (JAX reads it only
when it lowers the dry-run, and the port's layer loop is unrolled
already).  ``sharding_profile`` picks the placement rules
(``sharding/rules.py``) and, for ``moe_local*``, the MoE dispatch under a
mesh with a ``model`` axis (JAX's ``moe_apply_local``, ``models/moe.py``;
it raises on the dry-run's abstract meshes);
``seq_parallel`` constrains the residual stream (``models/transformer.
py``).  :class:`ShapeConfig`, ``LM_SHAPES`` and :func:`cell_is_runnable`
are the dry-run's (arch x shape) cells, and :class:`TrainConfig` is
``repro.configs.base.TrainConfig``, field for field.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

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
    # per-layer parallelism profile (sharding rule name)
    sharding_profile: str = "default"
    # attention: xla (dense) | xla_chunked | flash (the CUDA kernel)
    attn_impl: str = "xla"
    # sequence-parallel residual stream (shard the seq dim over `model`
    # between blocks)
    seq_parallel: bool = False

    @property
    def kv_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for long_500k (recurrent state or sliding window)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell. kind: train | prefill | decode."""
    name: str
    kind: str
    seq_len: int
    global_batch: int


LM_SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


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
    # 0=off, 8=int8 all-reduce (train/grad_compress.py); neither package's
    # fit reads it
    grad_compress_bits: int = 0
    checkpoint_every: int = 100
    checkpoint_dir: str = "checkpoints"


def shape_for(cfg: ModelConfig, shape_name: str) -> ShapeConfig:
    return LM_SHAPES[shape_name]


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig
                     ) -> Tuple[bool, Optional[str]]:
    """Whether an (arch x shape) cell runs, else the documented skip."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, ("full-attention arch: 500k dense decode skipped per "
                       "assignment; see DESIGN.md §Arch-applicability")
    return True, None
