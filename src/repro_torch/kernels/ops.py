"""Public wrappers for the kernels — counterpart of ``repro.kernels.ops``.

Where the JAX package runs its Pallas kernels in interpret mode on a CPU
backend, the port's wrappers run their plain PyTorch version on a CPU tensor
and the Hopper kernel on a CUDA tensor. Tile sizes are the kernels' own, so
the ``bm``/``bn`` arguments of the JAX wrappers have no counterpart.
"""

from __future__ import annotations

from .gmm import gmm, gmm_trainable
from .gmm_swiglu import gmm_swiglu
from .gmm_swiglu_bwd import gmm_swiglu_trainable
from .swiglu_add import swiglu_add_interleaved, swiglu_add_serial


def grouped_gemm(x, w):
    """[E, C, K] × [E, K, N] → [E, C, N] (expert-grouped, fp32 sums)."""
    return gmm(x, w)


def fused_gmm_swiglu(x, w_in):
    """[E, C, K] × [E, K, 2F] → [E, C, F], SwiGLU fused before the store."""
    return gmm_swiglu(x, w_in)


def moe_expert_ffn(x, w_in, w_down, act: str = "swiglu", *,
                   trainable: bool = False):
    """Full expert FFN through the kernels — drop-in ``gmm_fn`` for
    ``models.moe.moe_grouped``. Non-swiglu acts take the einsum path.

    ``trainable=True`` makes it differentiable: GMM1 + SwiGLU backs onto the
    ``gmm_swiglu_bwd`` kernel and GMM2 onto two more ``gmm`` calls. (The JAX
    function's ``trainable=True`` cannot be differentiated: its ``gmm`` has
    no VJP. The port does what that docstring says.)"""
    if act != "swiglu":
        from repro_torch.models.moe import expert_ffn
        return expert_ffn(w_in, w_down, x, act)
    w_in, w_down = w_in.to(x.dtype), w_down.to(x.dtype)
    if trainable:
        return gmm_trainable(gmm_swiglu_trainable(x, w_in), w_down)
    return grouped_gemm(fused_gmm_swiglu(x, w_in), w_down)


def swiglu_add(h, y, *, mode: str = "interleaved"):
    """SwiGLU + Add, [M, 2F], [M, F] → [M, F]: ``mode="interleaved"`` (one
    pass) or ``"serial"`` (two kernels through device memory)."""
    if mode == "interleaved":
        return swiglu_add_interleaved(h, y)
    if mode == "serial":
        return swiglu_add_serial(h, y)
    raise ValueError(f"mode must be 'interleaved' or 'serial', not {mode!r}")
