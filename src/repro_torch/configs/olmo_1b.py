"""olmo-1b — 16L d=2048 16H (kv=16) d_ff=8192 vocab=50304, non-parametric
LayerNorm. [arXiv:2402.00838]"""

from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b", family="dense",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab=50304, act="swiglu", norm="nonparam_ln",
        rope_theta=10000.0, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="olmo-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=128, act="swiglu", norm="nonparam_ln",
        tie_embeddings=True, vocab_pad=16, remat=False,
    )
