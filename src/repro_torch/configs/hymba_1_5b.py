"""hymba-1.5b [hybrid]: parallel attention + mamba/SSD heads,
sliding-window attention, ssm_state=16 (arXiv:2411.13676)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
        d_ff=5504, vocab_size=32001,
        ssm_state=16, sliding_window=1024)


def smoke_config() -> ModelConfig:
    return config().replace(n_layers=2, d_model=64, n_heads=4,
                            n_kv_heads=2, d_ff=128, vocab_size=512,
                            ssm_state=8, sliding_window=16, remat=False)
