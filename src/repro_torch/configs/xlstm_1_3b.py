"""xlstm-1.3b [ssm]: sLSTM + mLSTM blocks, xLSTM[7:1] layout
(arXiv:2405.04517)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b", family="ssm",
        n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=50304, slstm_every=8)


def smoke_config() -> ModelConfig:
    return config().replace(n_layers=4, d_model=64, n_heads=2,
                            n_kv_heads=2, vocab_size=512, slstm_every=2,
                            remat=False)
