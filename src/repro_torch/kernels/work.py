"""The work of one grouped-GEMM kernel call: its operations and bytes, and
their least time on the card.

The formulas count what the call must do, not what a kernel happens to do:
each input read once and each output written once over HBM, and 2
operations a multiply-add. ``chip_smoke.py`` bounds every timed kernel call
by them, and on the meta device each wrapper (``gmm``, ``gmm_swiglu``,
``gmm_swiglu_bwd``) reports them to the work counter of
``launch/dryrun.py`` (:func:`record`) in place of running: the counter then
sees the kernel's work, not that of its plain version (``ref.py``, which
upcasts to fp32 and applies SwiGLU in a pass of its own).
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from ..core.hardware import H100


def _item(dtype) -> int:
    return torch.finfo(dtype).bits // 8


def gmm_work(E, C, K, N, dtype, two: bool = False) -> tuple[int, int]:
    """(bytes, operations) of ``gmm`` ([E, C, K] x [E, K, N] -> [E, C, N])
    or, with ``two``, of ``gmm_swiglu`` (w_in [E, K, 2N] -> [E, C, N])."""
    w_cols = 2 * N if two else N
    nbytes = (E * C * K + E * K * w_cols + E * C * N) * _item(dtype)
    return nbytes, 2 * E * C * K * w_cols


def gmm_swiglu_bwd_work(E, C, K, F, dtype,
                        out_dtype=torch.float32) -> tuple[int, int]:
    """(bytes, operations) of ``gmm_swiglu_bwd``: x, w_in and dout read
    once, dx and dw written once in ``out_dtype``; the recompute of g and u,
    dx and dW are three products of 2·E·C·K·2F operations."""
    nbytes = ((E * C * K + E * K * 2 * F + E * C * F) * _item(dtype)
              + (E * C * K + E * K * 2 * F) * _item(out_dtype))
    return nbytes, 3 * 2 * E * C * K * 2 * F


def bound_ms(nbytes, n_ops, dtype, hw=H100) -> tuple[float, str]:
    """Least time (ms) of the work on the card and what sets it: the bytes
    over HBM's rate or the operations over the dtype's peak, the larger."""
    t_bytes = nbytes / hw.hbm_bytes_per_s
    t_ops = n_ops / hw.peak_flops(dtype)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def record(kernel: str, nbytes: int, n_ops: int) -> None:
    """Report a kernel call's work to every active dispatch mode that
    counts it (``record_kernel``): the meta branch of each wrapper."""
    for mode in _get_current_dispatch_mode_stack():
        fn = getattr(mode, "record_kernel", None)
        if fn is not None:
            fn(kernel, nbytes, n_ops)
