"""Grouped GEMM — wrapper of the Hopper kernel ``csrc/gmm.cu``.

Counterpart of ``repro.kernels.gmm.gmm``: ``[E, C, K] × [E, K, N] → [E, C, N]``
with fp32 sums and the output in x's dtype. The CUDA kernel masks ragged
C, N and K itself, so there is no block choice (``_pick_block``) and no VMEM
budget here. On a CPU tensor the plain version ``ref.gmm_ref`` runs; on a
CUDA tensor the kernel launches or the call raises.

Each operand is contiguous or the transpose of a contiguous tensor in its
last two dims (``operand_layout``); the kernel reads either in place.

``gmm_trainable`` adds the gradient that the JAX ``gmm`` lacks (it is a bare
``pallas_call`` with no VJP): two more calls of the same kernel on
transposed views of the saved operands, each keeping its reduction whole in
one CTA.
"""

from __future__ import annotations

import torch

from . import build
from .ref import gmm_ref

_DTYPES = (torch.float32, torch.bfloat16)

launches = 0   # kernel launches since the last reset (CPU calls not counted)


def check_operands(x, w, n_w: int) -> None:
    """Shared operand checks of the grouped-GEMM wrappers.

    ``w`` must be [E, K, n_w] for x [E, C, K], on x's device, in x's dtype.
    """
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"expected 3-d x and w, got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    E, _, K = x.shape
    if tuple(w.shape) != (E, K, n_w):
        raise ValueError(f"w {tuple(w.shape)} does not fit x "
                         f"{tuple(x.shape)}: want {(E, K, n_w)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x and w must both be float32 or bfloat16, got "
                        f"{x.dtype}, {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if x.device.type == "cuda" and E > 65535:
        raise ValueError(f"E={E} exceeds the kernel grid's 65535")


def operand_layout(t, name: str) -> int:
    """Layout code of a 3-d operand [E, R, S] for the kernel: 0 if it is
    contiguous, 1 if it is the transpose of a contiguous [E, S, R] (such as
    ``w.transpose(1, 2)``). Raises on any other strides."""
    if t.is_contiguous():
        return 0
    if t.transpose(1, 2).is_contiguous():
        return 1
    raise ValueError(f"gmm's {name} {tuple(t.shape)} has strides "
                     f"{t.stride()}: it takes a contiguous tensor or the "
                     f"transpose of one in its last two dims")


def gmm(x, w):
    """x: [E, C, K] expert-grouped tokens; w: [E, K, N] → [E, C, N]. Either
    operand may be a transposed view (``operand_layout``)."""
    global launches
    check_operands(x, w, w.shape[-1] if w.dim() == 3 else -1)
    layouts = operand_layout(x, "x"), operand_layout(w, "w")
    if x.device.type == "cpu":
        return gmm_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"gmm runs on cuda or cpu tensors, not {x.device}")
    E, C, _ = x.shape
    N = w.shape[-1]
    out = torch.empty((E, C, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    build.launch("gmm", x, w, out, E, C, x.shape[2], N, *layouts,
                 dtype=x.dtype)
    launches += 1
    return out


class _GmmTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return gmm(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = gmm(dy, w.transpose(1, 2))      # sum over N; views, no copies
        dw = gmm(x.transpose(1, 2), dy)      # sum over C
        return dx, dw


def gmm_trainable(x, w):
    """``gmm`` with its gradient through the same kernel: x [E, C, K],
    w [E, K, N] → [E, C, N]; dx = dy·wᵀ, dw = xᵀ·dy."""
    return _GmmTrainable.apply(x, w)
