"""hubert-xlarge — 48L d=1280 16H d_ff=5120 vocab=504 (cluster targets),
encoder-only (non-causal), GELU MLP, LayerNorm, stub frame frontend.
[arXiv:2106.07447]"""

from repro_torch.models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="audio",
        n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
        d_ff=5120, vocab=504, act="gelu", norm="layernorm",
        rope_theta=0.0, causal=False, feat_in=512, vocab_pad=8,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hubert-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=32, act="gelu", norm="layernorm",
        rope_theta=0.0, causal=False, feat_in=16, vocab_pad=8,
        remat=False,
    )
