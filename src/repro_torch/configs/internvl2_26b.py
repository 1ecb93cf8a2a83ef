"""internvl2-26b [vlm] — InternViT + InternLM2 backbone; ViT patch
embeddings come in via the stub frontend. [arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b", family="vlm",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab_size=92553, frontend="patch_stub")


def smoke_config() -> ModelConfig:
    return config().replace(n_layers=2, d_model=64, n_heads=4,
                            n_kv_heads=2, d_ff=128, vocab_size=512,
                            remat=False)
