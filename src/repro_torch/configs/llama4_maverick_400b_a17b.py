"""llama4-maverick-400b-a17b [moe] — 128 experts top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=8192, vocab_size=202048,
        n_experts=128, experts_per_token=1)


def smoke_config() -> ModelConfig:
    return config().replace(n_layers=2, d_model=64, n_heads=4,
                            n_kv_heads=2, d_ff=96, vocab_size=512,
                            n_experts=8, experts_per_token=1, remat=False)
