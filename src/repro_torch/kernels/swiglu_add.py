"""SwiGLU + Add, serial and interleaved — wrappers of ``csrc/swiglu_add.cu``.

Counterpart of ``repro.kernels.swiglu_add``, the paper's §6.1 microbenchmark:
h ``[M, 2F]``, y ``[M, F]`` → ``silu(h[:, :F]) · h[:, F:] + y``.

``serial``      — two launches: the SwiGLU kernel stores g ``[M, F]`` to
                  device memory in h's dtype, the Add kernel reads it back.
``interleaved`` — one launch: SwiGLU and Add in registers, one store.

The JAX kernels take row tiles of ``bm`` rows and need ``M % bm == 0``; the
CUDA kernels mask any M and any even 2F, so there is no ``bm`` here. On a CPU
tensor the plain versions in ``ref`` run and count no launch; on a CUDA
tensor the kernels launch or the call raises.
"""

from __future__ import annotations

import torch

from . import build
from .ref import swiglu_add_ref, swiglu_add_serial_ref

_DTYPES = (torch.float32, torch.bfloat16)

# Kernel launches since the last reset (CPU calls not counted): two per
# serial call, one per interleaved call.
launches_serial = 0
launches_interleaved = 0


def check_operands(h, y) -> None:
    """h [M, 2F] and y [M, F] on one device, in one dtype (fp32 or bf16)."""
    if h.dim() != 2 or y.dim() != 2:
        raise ValueError(f"expected 2-d h and y, got {tuple(h.shape)}, "
                         f"{tuple(y.shape)}")
    M, F2 = h.shape
    if F2 % 2:
        raise ValueError(f"h's last dimension {F2} is not even")
    if tuple(y.shape) != (M, F2 // 2):
        raise ValueError(f"y {tuple(y.shape)} does not fit h "
                         f"{tuple(h.shape)}: want {(M, F2 // 2)}")
    if h.dtype not in _DTYPES or y.dtype != h.dtype:
        raise TypeError(f"h and y must both be float32 or bfloat16, got "
                        f"{h.dtype}, {y.dtype}")
    if y.device != h.device:
        raise ValueError(f"h on {h.device}, y on {y.device}")
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"swiglu_add runs on cuda or cpu tensors, not "
                         f"{h.device}")
    if h.device.type == "cuda" and not (h.is_contiguous()
                                        and y.is_contiguous()):
        raise ValueError("the CUDA kernels take contiguous h and y")


def swiglu_add_serial(h, y):
    """Two kernels with a device-memory round trip of g between them."""
    global launches_serial
    check_operands(h, y)
    if h.device.type == "cpu":
        return swiglu_add_serial_ref(h, y)
    M, F = y.shape
    out = torch.empty_like(y)
    if out.numel() == 0:
        return out
    g = torch.empty_like(y)
    build.launch("swiglu", h, g, M, F, dtype=h.dtype)
    build.launch("add", g, y, out, M, F, dtype=h.dtype)
    launches_serial += 2
    return out


def swiglu_add_interleaved(h, y):
    """One kernel: the intermediate never leaves the registers."""
    global launches_interleaved
    check_operands(h, y)
    if h.device.type == "cpu":
        return swiglu_add_ref(h, y)
    M, F = y.shape
    out = torch.empty_like(y)
    if out.numel() == 0:
        return out
    build.launch("swiglu_add", h, y, out, M, F, dtype=h.dtype)
    launches_interleaved += 1
    return out
