"""Fused GMM1 + SwiGLU — wrapper of the Hopper kernel ``csrc/gmm_swiglu.cu``.

Counterpart of ``repro.kernels.gmm_swiglu.gmm_swiglu``:
``x [E, C, K] × w_in [E, K, 2F] (gate ‖ up) → silu(x·Wg) ⊙ (x·Wu) [E, C, F]``,
two fp32 accumulators and SwiGLU before the single store. On a CPU tensor the
plain version ``ref.gmm_swiglu_ref`` runs; on a CUDA tensor the kernel
launches or the call raises; on a meta tensor the call reports the
kernel's work to the dry run's counter (``work.record``) and returns an
empty output.
"""

from __future__ import annotations

import torch

from . import build, work
from .gmm import check_operands, tensor_core_body
from .ref import gmm_swiglu_ref

# Kernel launches since the last reset (CPU calls not counted): all, and
# those of the tensor-core body.
launches = 0
launches_tc = 0


def gmm_swiglu(x, w_in):
    """x: [E, C, K]; w_in: [E, K, 2F] (gate ‖ up) → [E, C, F]."""
    global launches, launches_tc
    two_f = w_in.shape[-1] if w_in.dim() == 3 else -1
    if two_f % 2:
        raise ValueError(f"w_in's last dim {two_f} is not 2F")
    check_operands(x, w_in, two_f)
    if x.device.type == "cuda" and not (x.is_contiguous()
                                        and w_in.is_contiguous()):
        raise ValueError("gmm_swiglu's CUDA kernel takes contiguous x and "
                         "w_in")
    if x.device.type == "cpu":
        return gmm_swiglu_ref(x, w_in)
    E, C, K = x.shape
    F = two_f // 2
    if x.device.type == "meta":      # the kernel's work, counted; no launch
        work.record("gmm_swiglu",
                    *work.gmm_work(E, C, K, F, x.dtype, two=True))
        return torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if x.device.type != "cuda":
        raise ValueError(
            f"gmm_swiglu runs on cuda, cpu or meta tensors, not {x.device}")
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    build.launch("gmm_swiglu", x, w_in, out, E, C, x.shape[2], F,
                 dtype=x.dtype)
    launches += 1
    launches_tc += tensor_core_body(x, w_in, out)
    return out
