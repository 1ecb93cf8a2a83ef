"""whisper-tiny [audio]: encoder-decoder, conv frontend stubbed
(arXiv:2212.04356)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny", family="audio",
        n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
        d_ff=1536, vocab_size=51865,
        n_enc_layers=4, enc_seq=1500,
        rope_theta=0.0, tie_embeddings=True, frontend="audio_stub")


def smoke_config() -> ModelConfig:
    return config().replace(n_layers=2, n_enc_layers=2, d_model=64,
                            n_heads=4, n_kv_heads=4, d_ff=128,
                            vocab_size=512, enc_seq=16, remat=False)
