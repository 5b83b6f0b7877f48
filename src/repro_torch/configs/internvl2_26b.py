"""internvl2-26b — InternLM2 backbone: 48L d=6144 48H (GQA kv=8)
d_ff=16384 vocab=92553; InternViT frontend is a stub providing
precomputed patch embeddings. [arXiv:2404.16821]"""

from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b", family="vlm",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab=92553, act="swiglu", norm="rmsnorm",
        rope_theta=1000000.0, n_patches=256,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=128, act="swiglu", norm="rmsnorm",
        n_patches=8, vocab_pad=16, remat=False,
    )
