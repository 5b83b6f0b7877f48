"""Backward of the fused GMM1 + SwiGLU — wrapper of the Hopper kernel
``csrc/gmm_swiglu_bwd.cu``.

Counterpart of ``repro.kernels.gmm_swiglu_bwd``. The backward is
flash-style: the forward saves only ``(x, w_in)``, and the kernel recomputes
the gate and up products instead of keeping the ``[E, C, 2F]`` intermediate.

* ``gmm_swiglu_bwd(x, w4, dout, out_dtype=torch.float32) -> (dx, dw4)``:
  fp32 sums, returned in fp32 as in the JAX function, or rounded once to
  ``out_dtype`` by the kernel.
* ``gmm_swiglu_trainable(x, w_in)``, the ``torch.autograd.Function`` that
  replaces ``jax.custom_vjp``: forward through the ``gmm_swiglu`` kernel,
  backward through ``gmm_swiglu_bwd`` with grads in the primal dtype.

On a CPU tensor the plain version ``ref.gmm_swiglu_bwd_ref`` runs; on a
CUDA tensor the kernel launches or the call raises; on a meta tensor the
call reports the kernel's work to the dry run's counter (``work.record``)
and returns empty outputs. bf16 calls that tensor
maps can describe run the tensor-core body; fp32 calls and the rest run the
FMA body (``tensor_core_body``). Each body has its launch count.
"""

from __future__ import annotations

import torch

from . import build, work
from .gmm import check_operands
from .gmm_swiglu import gmm_swiglu
from .ref import gmm_swiglu_bwd_ref

# Kernel launches since the last reset (CPU calls not counted): all, and
# those of the tensor-core body.
launches = 0
launches_tc = 0

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def tensor_core_body(x, w4, dout) -> bool:
    """Whether a CUDA call runs the tensor-core body: bf16 operands on
    16-byte aligned bases, and K and F multiples of 8, so that TMA tensor
    maps describe every operand (the kernel's ``gsbtc::usable``)."""
    K, F = w4.shape[1], w4.shape[3]
    return (x.dtype == torch.bfloat16 and K % 8 == 0 and F % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, w4, dout)))


def gmm_swiglu_bwd(x, w4, dout, out_dtype=torch.float32):
    """x: [E, C, K]; w4: [E, K, 2, F] (gate, up); dout: [E, C, F] →
    (dx [E, C, K], dw4 [E, K, 2, F]) in ``out_dtype`` (fp32 or bf16), from
    fp32 sums."""
    global launches, launches_tc
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
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, not "
                        f"{out_dtype}")
    if x.device.type == "cpu":
        dx, dw4 = gmm_swiglu_bwd_ref(x, w4, dout)
        return dx.to(out_dtype), dw4.to(out_dtype)
    if x.device.type == "meta":      # the kernel's work, counted; no launch
        work.record("gmm_swiglu_bwd", *work.gmm_swiglu_bwd_work(
            E, C, K, F, x.dtype, out_dtype))
        return (torch.empty((E, C, K), dtype=out_dtype, device=x.device),
                torch.empty((E, K, 2, F), dtype=out_dtype, device=x.device))
    if x.device.type != "cuda":
        raise ValueError(f"gmm_swiglu_bwd runs on cuda, cpu or meta "
                         f"tensors, not {x.device}")
    if not (x.is_contiguous() and w4.is_contiguous()
            and dout.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous x, w4 and dout")
    if E * C * K * F == 0:
        return (torch.zeros((E, C, K), dtype=out_dtype, device=x.device),
                torch.zeros((E, K, 2, F), dtype=out_dtype, device=x.device))
    tc = tensor_core_body(x, w4, dout)
    # The FMA body stores fp32 only: a bf16 result is cast after it.
    kernel_dtype = out_dtype if tc else torch.float32
    dx = torch.empty((E, C, K), dtype=kernel_dtype, device=x.device)
    dw4 = torch.empty((E, K, 2, F), dtype=kernel_dtype, device=x.device)
    # dg ‖ du in w_in's column layout, written once and read by the dx and
    # dw products: fp32 (FMA body), or the bf16 hi and lo halves (tensor
    # cores), 4·E·C·2F bytes either way.
    dgu = torch.empty((E, C, 2 * F), dtype=torch.float32, device=x.device)
    build.launch("gmm_swiglu_bwd", x, w4, dout, dx, dw4, dgu, E, C, K, F,
                 int(tc), build.dtype_code(kernel_dtype),
                 dtype=x.dtype)
    launches += 1
    launches_tc += tc
    return dx.to(out_dtype), dw4.to(out_dtype)


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
        dx, dw4 = gmm_swiglu_bwd(x, w4, dout.contiguous(),
                                 out_dtype=x.dtype)
        return dx, dw4.reshape(E, K, two_f)


def gmm_swiglu_trainable(x, w_in):
    """``gmm_swiglu`` with the hand-written backward: x [E, C, K], w_in
    [E, K, 2F] (gate ‖ up) → [E, C, F]."""
    return _GmmSwigluTrainable.apply(x, w_in)
