"""granite-moe-3b-a800m — 32L d=1536 24H (GQA kv=8) expert_ff=512 vocab=49155,
MoE 40 experts top-8. [hf:ibm-granite/granite-3.0-*; assignment header is
authoritative: 40e top-8.] Experts padded 40→48 so E % 16 == 0 on the
production mesh (router never selects padding)."""

from repro_torch.models.model import ModelConfig
from repro_torch.models.moe import MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
        d_ff=512, vocab=49155, act="swiglu", norm="rmsnorm",
        rope_theta=10000.0,
        moe=MoEConfig(n_experts=40, top_k=8, d_expert=512,
                      n_padding_experts=8),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=32, vocab=128, act="swiglu", norm="rmsnorm",
        moe=MoEConfig(n_experts=5, top_k=2, d_expert=32,
                      n_padding_experts=1),
        vocab_pad=16, remat=False,
    )
