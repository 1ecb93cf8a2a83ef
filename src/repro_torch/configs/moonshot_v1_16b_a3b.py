"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64 experts top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab_size=163840,
        n_experts=64, experts_per_token=6)


def smoke_config() -> ModelConfig:
    return config().replace(n_layers=2, d_model=64, n_heads=4,
                            n_kv_heads=4, d_ff=96, vocab_size=512,
                            n_experts=8, experts_per_token=2, remat=False)
