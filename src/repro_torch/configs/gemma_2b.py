"""gemma-2b — 18L d=2048 8H (MQA kv=1) d_ff=16384 head_dim=256
vocab=256000, GeGLU, sqrt(d) embed scaling. [arXiv:2403.08295]"""

from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b", family="dense",
        n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
        head_dim=256, d_ff=16384, vocab=256000, act="geglu",
        norm="rmsnorm", rope_theta=10000.0, embed_scale=True,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
        head_dim=32, d_ff=128, vocab=128, act="geglu", norm="rmsnorm",
        embed_scale=True, tie_embeddings=True, vocab_pad=16, remat=False,
    )
