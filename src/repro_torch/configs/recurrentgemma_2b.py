"""recurrentgemma-2b — 26L d=2560 10H (MQA kv=1) d_ff=7680 vocab=256000,
RG-LRU + local attention 1:2 pattern (R,R,A), window 2048, GeGLU.
[arXiv:2402.19427]"""

from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
        head_dim=256, d_ff=7680, vocab=256000, act="geglu",
        norm="rmsnorm", rope_theta=10000.0, sliding_window=2048,
        hybrid_pattern=("rglru", "rglru", "local_attn"),
        lru_width=2560, embed_scale=True, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rgemma-smoke", family="hybrid",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=1,
        head_dim=16, d_ff=128, vocab=128, act="geglu", norm="rmsnorm",
        sliding_window=16,
        hybrid_pattern=("rglru", "rglru", "local_attn"),
        lru_width=64, embed_scale=True, tie_embeddings=True,
        vocab_pad=16, remat=False,
    )
