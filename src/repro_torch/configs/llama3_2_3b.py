"""llama3.2-3b — 28L d=3072 24H (GQA kv=8) d_ff=8192 vocab=128256.
[hf:meta-llama/Llama-3.2-3B]"""

from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b", family="dense",
        n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=8192, vocab=128256, act="swiglu", norm="rmsnorm",
        rope_theta=500000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=128, act="swiglu", norm="rmsnorm",
        vocab_pad=16, remat=False,
    )
