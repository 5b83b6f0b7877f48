"""qwen2-1.5b — 28L d=1536 12H (GQA kv=2) d_ff=8960 vocab=151936, QKV bias.
[arXiv:2407.10671]"""

from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b", family="dense",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
        d_ff=8960, vocab=151936, act="swiglu", norm="rmsnorm",
        qkv_bias=True, rope_theta=1000000.0, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=128, act="swiglu", norm="rmsnorm",
        qkv_bias=True, tie_embeddings=True, vocab_pad=16, remat=False,
    )
