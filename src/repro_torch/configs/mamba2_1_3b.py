"""mamba2-1.3b — 48L d=2048 attn-free SSD, ssm_state=128 vocab=50280.
[arXiv:2405.21060]"""

from repro_torch.models.model import ModelConfig
from repro_torch.models.ssm import SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b", family="ssm",
        n_layers=48, d_model=2048, vocab=50280, norm="rmsnorm",
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256),
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm",
        n_layers=2, d_model=64, vocab=128, norm="rmsnorm",
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, chunk=8),
        tie_embeddings=True, vocab_pad=16, remat=False,
    )
