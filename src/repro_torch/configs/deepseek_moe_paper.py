"""The paper's DeepSeek-V3-style MoE-FFN evaluation module (§5.2) —
counterpart of ``repro.configs.deepseek_moe_paper``: hidden 7168, expert
intermediate 2048, top-8, 8 local experts per rank; EP in {4, 8, 16} →
32/64/128 experts. Used by the module benchmark
(``launch.bench_ep_modes``), not a training cell."""

from repro_torch.models.model import ModelConfig
from repro_torch.models.moe import MoEConfig


def config(ep: int = 8, n_layers: int = 4) -> ModelConfig:
    return ModelConfig(
        name=f"deepseek-moe-ep{ep}", family="moe",
        n_layers=n_layers, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=2048, vocab=129280, act="swiglu", norm="rmsnorm",
        moe=MoEConfig(n_experts=8 * ep, top_k=8, d_expert=2048),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=32, vocab=128, act="swiglu", norm="rmsnorm",
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=32),
        vocab_pad=16, remat=False,
    )
