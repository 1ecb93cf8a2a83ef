"""llama3.2-1b [dense]: small llama3 with tied embeddings
(hf:meta-llama/Llama-3.2-1B)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b", family="dense",
        n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
        d_ff=8192, vocab_size=128256,
        rope_theta=500000.0, tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return config().replace(n_layers=2, d_model=64, n_heads=4,
                            n_kv_heads=2, d_ff=128, vocab_size=512)
