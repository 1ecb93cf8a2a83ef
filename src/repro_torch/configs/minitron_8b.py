"""minitron-8b [dense] — pruned nemotron. [arXiv:2407.14679; hf]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=16384, vocab_size=256000)


def smoke_config() -> ModelConfig:
    return config().replace(n_layers=2, d_model=64, n_heads=4,
                            n_kv_heads=2, d_ff=128, vocab_size=512,
                            remat=False)
