"""Backward of the fused GMM1 + SwiGLU — wrapper of the Hopper kernel
``csrc/gmm_swiglu_bwd.cu``.

Counterpart of ``repro.kernels.gmm_swiglu_bwd``. The backward is
flash-style: the forward saves only ``(x, w_in)``, and the kernel recomputes
the gate and up products instead of keeping the ``[E, C, 2F]`` intermediate.

* ``gmm_swiglu_bwd(x, w4, dout) -> (dx, dw4)``, fp32 sums as in the JAX
  function; the caller casts them.
* ``gmm_swiglu_trainable(x, w_in)``, the ``torch.autograd.Function`` that
  replaces ``jax.custom_vjp``: forward through the ``gmm_swiglu`` kernel,
  backward through ``gmm_swiglu_bwd``, grads cast to the primal dtypes.

On a CPU tensor the plain version ``ref.gmm_swiglu_bwd_ref`` runs; on a
CUDA tensor the kernel launches or the call raises.
"""

from __future__ import annotations

import torch

from . import build
from .gmm import check_operands
from .gmm_swiglu import gmm_swiglu
from .ref import gmm_swiglu_bwd_ref

launches = 0   # kernel launches since the last reset (CPU calls not counted)


def gmm_swiglu_bwd(x, w4, dout):
    """x: [E, C, K]; w4: [E, K, 2, F] (gate, up); dout: [E, C, F] →
    (dx fp32 [E, C, K], dw4 fp32 [E, K, 2, F])."""
    global launches
    if w4.dim() != 4 or w4.shape[2] != 2:
        raise ValueError(f"w4 must be [E, K, 2, F], got {tuple(w4.shape)}")
    E, K, _, F = w4.shape
    check_operands(x, w4.reshape(E, K, 2 * F), 2 * F)
    C = x.shape[1]
    if tuple(dout.shape) != (E, C, F):
        raise ValueError(f"dout {tuple(dout.shape)} does not fit x "
                         f"{tuple(x.shape)}: want {(E, C, F)}")
    if dout.dtype != x.dtype or dout.device != x.device:
        raise TypeError(f"dout must be {x.dtype} on {x.device}, got "
                        f"{dout.dtype} on {dout.device}")
    if x.device.type == "cpu":
        return gmm_swiglu_bwd_ref(x, w4, dout)
    if x.device.type != "cuda":
        raise ValueError(
            f"gmm_swiglu_bwd runs on cuda or cpu tensors, not {x.device}")
    if not (x.is_contiguous() and w4.is_contiguous()
            and dout.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous x, w4 and dout")
    if E * C * K * F == 0:
        return (torch.zeros((E, C, K), dtype=torch.float32, device=x.device),
                torch.zeros((E, K, 2, F), dtype=torch.float32,
                            device=x.device))
    dx = torch.empty((E, C, K), dtype=torch.float32, device=x.device)
    dw4 = torch.empty((E, K, 2, F), dtype=torch.float32, device=x.device)
    # dg ‖ du in w_in's column layout: written once, read by the dx and dw
    # products.
    dgu = torch.empty((E, C, 2 * F), dtype=torch.float32, device=x.device)
    build.launch("gmm_swiglu_bwd", x, w4, dout, dx, dw4, dgu, E, C, K, F,
                 dtype=x.dtype)
    launches += 1
    return dx, dw4


class _GmmSwigluTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_in):
        ctx.save_for_backward(x, w_in)
        return gmm_swiglu(x, w_in)

    @staticmethod
    def backward(ctx, dout):
        x, w_in = ctx.saved_tensors
        E, K, two_f = w_in.shape
        w4 = w_in.reshape(E, K, 2, two_f // 2)
        dx, dw4 = gmm_swiglu_bwd(x, w4, dout.contiguous())
        return dx.to(x.dtype), dw4.reshape(E, K, two_f).to(w_in.dtype)


def gmm_swiglu_trainable(x, w_in):
    """``gmm_swiglu`` with the hand-written backward: x [E, C, K], w_in
    [E, K, 2F] (gate ‖ up) → [E, C, F]."""
    return _GmmSwigluTrainable.apply(x, w_in)
