"""Grouped GEMM — wrapper of the Hopper kernel ``csrc/gmm.cu``.

Counterpart of ``repro.kernels.gmm.gmm``: ``[E, C, K] × [E, K, N] → [E, C, N]``
with fp32 sums and the output in x's dtype. The CUDA kernel masks ragged
C, N and K itself, so there is no block choice (``_pick_block``) and no VMEM
budget here. On a CPU tensor the plain version ``ref.gmm_ref`` runs; on a
CUDA tensor the kernel launches or the call raises. On a meta tensor
nothing runs: the call reports the kernel's work (``work.gmm_work``) to
the dry run's counter and returns an empty output of the kernel's shape and
dtype.

Each operand is contiguous or the transpose of a contiguous tensor in its
last two dims (``operand_layout``); the kernel reads either in place.

The C entry has five bodies: bf16 calls run the tensor cores where a
tensor map describes them, else the first design's FMA body; fp32 calls
large enough to fill the card (``tiled_takes``) run the register-blocked
tiled body (``csrc/gmm_fp32.cuh``) at a tile the wrapper picks, smaller
ones the narrow body (``csrc/gmm_fp32_narrow.cuh``: 8-column CTAs fed by
TMA) at a configuration the wrapper picks, and the calls neither takes (x
a transposed view in the narrow body's range, widths or bases that are not
multiples of 16 bytes) the small-row body (``csrc/gmm_fp32_small.cuh``).
``fp32_tile`` gives the body code, ``fp32_body`` names the body. All three
fp32 bodies sum each output in one fmaf chain over ascending k, so on the
card an fp32 row's bits do not depend on how many rows the call has.

``gmm_trainable`` adds the gradient that the JAX ``gmm`` lacks (it is a bare
``pallas_call`` with no VJP): two more calls of the same kernel on
transposed views of the saved operands, each keeping its reduction whole in
one CTA.
"""

from __future__ import annotations

import functools

import torch

from . import build, work
from .ref import gmm_ref

_DTYPES = (torch.float32, torch.bfloat16)

# Kernel launches since the last reset (CPU calls not counted): all, and
# those of the bf16 tensor-core body and of the fp32 tiled, narrow and
# small-row bodies.
launches = 0
launches_tc = 0
launches_fp32_tiled = 0
launches_fp32_narrow = 0
launches_fp32_small = 0

# The fp32 tiled body's tiles (rows x columns of one CTA's output), by the
# code the C entry takes; largest first. fp32_tile's pick among them was
# within 1% of the fastest at each dropless call at C = 683, and 9% at
# C = 1001 (launch/bench_gmm_fma.py --tiles on an H100; PERF.md).
FP32_TILES = {1: (64, 128), 2: (64, 64), 3: (32, 64)}
# The fp32 narrow body's configurations (TM, TN, W, CL) by the code the C
# entry takes: W consumer warps of 32 / CL row lanes by CL column lanes,
# each thread TM rows by TN columns, so that a CTA owns (32 / CL)·TM·W rows
# by CL·TN columns: 4, 8, 32 and 64 rows, all 8 columns wide.
FP32_NARROW = {4: (1, 1, 1, 8), 5: (1, 1, 2, 8), 6: (2, 1, 4, 8),
               7: (1, 4, 4, 2)}
# The narrow body's pick by rows: (most rows, code), the first that takes
# C; calls of more rows take the last code (bench_gmm_fma.py --tiles times
# every code on an H100; PERF.md).
NARROW_BY_ROWS = ((4, 4), (16, 5), (32, 6), (None, 7))
# fp32 calls run the tiled body from FP32_TILED_MIN_ROWS rows, or once the
# grid of its smallest tile, E·⌈C/32⌉·⌈N/64⌉ CTAs, reaches
# FP32_TILED_MIN_CTAS; smaller calls run the narrow body. On an H100 (132
# SMs; bench_gmm_fma.py --tiles at C = 1 ... 256, PERF.md) the narrow body
# is faster while that grid stays under 72 CTAs (N = 1536 to C = 64,
# N = 1024 to C = 128, N = 512 to C = 256) and slower at 72 (N = 1536,
# C = 96); the sweep ends at 256 rows.
FP32_TILED_MIN_ROWS = 257
FP32_TILED_MIN_CTAS = 72
# SMs of the card the tiles are picked for, where a tensor lies on the CPU
# (an H100 SXM's 132).
CPU_SMS = 132


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


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    if device.type != "cuda":
        return CPU_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def fp32_tile(x, w) -> int:
    """The body code a ``gmm(x, w)`` call passes to its C entry: 0 for the
    tensor cores, the FMA body (bf16) or the small-row body (fp32), an
    ``FP32_TILES`` code for the fp32 tiled body, an ``FP32_NARROW`` code for
    the fp32 narrow body.

    fp32 calls the tiled body takes by size (``tiled_takes``) run it where
    their operands' contiguous dims (x: K, or C if a transposed view; w: N,
    or K) and N are multiples of 4 and their bases 16-byte aligned. Its
    tile is the largest whose grid, E·⌈C/BM⌉·⌈N/BN⌉ CTAs, has at least two
    CTAs per SM of the card; else the smallest. Smaller calls run the
    narrow body where TMA can describe them (``narrow_usable``), at
    ``narrow_code(C)``. Every other fp32 call runs the small-row body.
    """
    return _tile(x, w, operand_layout(x, "x"), operand_layout(w, "w"))


def tiled_takes(E: int, C: int, N: int) -> bool:
    """Whether an fp32 call of E experts, C rows and N columns is the tiled
    body's by size: from ``FP32_TILED_MIN_ROWS`` rows, or once its smallest
    tile's grid reaches ``FP32_TILED_MIN_CTAS`` CTAs."""
    bm, bn = FP32_TILES[max(FP32_TILES)]
    return (C >= FP32_TILED_MIN_ROWS
            or E * -(-C // bm) * -(-N // bn) >= FP32_TILED_MIN_CTAS)


def narrow_usable(x, w, x_layout: int, w_layout: int) -> bool:
    """Whether the narrow body's tensor maps describe the call (its
    ``gmmn::usable``): x contiguous with K a multiple of 4 floats, w's
    contiguous dim (N, or K if a transposed view) a multiple of 4, and both
    bases 16-byte aligned."""
    K, N = x.shape[2], w.shape[2]
    return (x_layout == 0 and K > 0 and K % 4 == 0
            and (w_layout == 1 or N % 4 == 0)
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


def narrow_rows(code: int) -> int:
    """Rows of one CTA of the narrow body at configuration ``code``."""
    tm, _, warps, cl = FP32_NARROW[code]
    return 32 // cl * tm * warps


def narrow_cols(code: int) -> int:
    """Columns of one CTA of the narrow body at configuration ``code``."""
    _, tn, _, cl = FP32_NARROW[code]
    return cl * tn


def narrow_code(C: int) -> int:
    """The narrow body's configuration for a call of C rows: the first of
    ``NARROW_BY_ROWS`` whose row bound takes C."""
    return next(code for most, code in NARROW_BY_ROWS
                if most is None or C <= most)


def _tile(x, w, x_layout: int, w_layout: int) -> int:
    E, C, K = x.shape
    N = w.shape[-1]
    if x.dtype != torch.float32:
        return 0
    if not tiled_takes(E, C, N):
        return (narrow_code(C) if narrow_usable(x, w, x_layout, w_layout)
                else 0)
    x_dim = C if x_layout else K
    w_dim = K if w_layout else N
    if (x_dim % 4 or w_dim % 4 or N % 4 or x.data_ptr() % 16
            or w.data_ptr() % 16):
        return 0
    slots = 2 * _sms(x.device)
    for code, (bm, bn) in FP32_TILES.items():
        if E * -(-C // bm) * -(-N // bn) >= slots:
            return code
    return code


def tensor_core_body(x, w, out, layouts=(0, 0)) -> bool:
    """Whether the C entry runs a bf16 call on the tensor cores: its
    ``gmmtc::usable`` rule — 16-byte aligned bases, and x's and w's row
    strides and the output's width multiples of 8 elements. For
    ``gmm_swiglu`` w is w_in [E, K, 2F] and out [E, C, F]."""
    la, lb = layouts
    lda = x.shape[1] if la else x.shape[2]
    ldb = w.shape[1] if lb else w.shape[2]
    return (x.dtype == torch.bfloat16 and lda % 8 == 0 and ldb % 8 == 0
            and out.shape[2] % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, w, out)))


def fp32_body(x, w) -> str:
    """Which body a ``gmm(x, w)`` call on the card runs in fp32: "tiled"
    (``csrc/gmm_fp32.cuh``), "narrow" (``csrc/gmm_fp32_narrow.cuh``) or
    "small" (``csrc/gmm_fp32_small.cuh``); "none" for a bf16 call, which
    runs none of them."""
    return body_name(x.dtype, fp32_tile(x, w))


def body_name(dtype, code: int) -> str:
    """The fp32 body that body code ``code`` runs (``fp32_body``)."""
    if dtype != torch.float32:
        return "none"
    if code in FP32_TILES:
        return "tiled"
    return "narrow" if code in FP32_NARROW else "small"


def gmm(x, w):
    """x: [E, C, K] expert-grouped tokens; w: [E, K, N] → [E, C, N]. Either
    operand may be a transposed view (``operand_layout``)."""
    global launches, launches_tc, launches_fp32_tiled, launches_fp32_narrow
    global launches_fp32_small
    check_operands(x, w, w.shape[-1] if w.dim() == 3 else -1)
    layouts = operand_layout(x, "x"), operand_layout(w, "w")
    if x.device.type == "cpu":
        return gmm_ref(x, w)
    E, C, K = x.shape
    N = w.shape[-1]
    if x.device.type == "meta":      # the kernel's work, counted; no launch
        work.record("gmm", *work.gmm_work(E, C, K, N, x.dtype))
        return torch.empty((E, C, N), dtype=x.dtype, device=x.device)
    if x.device.type != "cuda":
        raise ValueError(
            f"gmm runs on cuda, cpu or meta tensors, not {x.device}")
    out = torch.empty((E, C, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    body = _tile(x, w, *layouts)
    build.launch("gmm", x, w, out, E, C, x.shape[2], N, *layouts, body,
                 dtype=x.dtype)
    launches += 1
    launches_tc += tensor_core_body(x, w, out, layouts)
    name = body_name(x.dtype, body)
    launches_fp32_tiled += name == "tiled"
    launches_fp32_narrow += name == "narrow"
    launches_fp32_small += name == "small"
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
