"""dbrx-132b — 40L d=6144 48H (GQA kv=8) expert_ff=10752 vocab=100352,
MoE 16 experts top-4, fine-grained. [hf:databricks/dbrx-base]"""

from repro_torch.models.model import ModelConfig
from repro_torch.models.moe import MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=10752, vocab=100352, act="swiglu", norm="layernorm",
        rope_theta=500000.0,
        moe=MoEConfig(n_experts=16, top_k=4, d_expert=10752),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab=128, act="swiglu", norm="layernorm",
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=96),
        vocab_pad=16, remat=False,
    )
