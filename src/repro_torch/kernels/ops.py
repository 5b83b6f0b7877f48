"""Public wrappers for the kernels — counterpart of ``repro.kernels.ops``.

Where the JAX package runs its Pallas kernels in interpret mode on a CPU
backend, the port's wrappers run their plain PyTorch version on a CPU tensor
and the Hopper kernel on a CUDA tensor. Tile sizes are the kernels' own, so
the ``bm``/``bn`` arguments of the JAX wrappers have no counterpart.
"""

from __future__ import annotations

from .gmm import gmm
from .gmm_swiglu import gmm_swiglu


def grouped_gemm(x, w):
    """[E, C, K] × [E, K, N] → [E, C, N] (expert-grouped, fp32 sums)."""
    return gmm(x, w)


def fused_gmm_swiglu(x, w_in):
    """[E, C, K] × [E, K, 2F] → [E, C, F], SwiGLU fused before the store."""
    return gmm_swiglu(x, w_in)


def moe_expert_ffn(x, w_in, w_down, act: str = "swiglu", *,
                   trainable: bool = False):
    """Full expert FFN through the kernels — drop-in ``gmm_fn`` for
    ``models.moe.moe_grouped``. Non-swiglu acts take the einsum path."""
    if act != "swiglu":
        from repro_torch.models.moe import expert_ffn
        return expert_ffn(w_in, w_down, x, act)
    if trainable:
        raise NotImplementedError(
            "trainable=True needs the gmm_swiglu_bwd kernel, which comes "
            "with the port's training slice")
    g = fused_gmm_swiglu(x, w_in.to(x.dtype))
    return grouped_gemm(g, w_down.to(x.dtype))
