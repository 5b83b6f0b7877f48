"""§6.1 SwiGLU + Add, serial vs interleaved — counterpart of
``benchmarks/bench_swiglu_add.py``.

On the card (the default), the paper's h [M, 4096], y [M, 2048] at
M = 8192, 16384 and 32768 in bf16 and fp32:
    PYTHONPATH=src python -m repro_torch.launch.bench_swiglu_add
On the CPU, with the plain versions and no times:
    PYTHONPATH=src python -m repro_torch.launch.bench_swiglu_add \\
        --device cpu --sizes 256

Two artifacts, as CSV rows ``name,us_per_call,derived``:

1. Simulator rows, under the reference's names: the §6 SwiGLU → Add graph
   compiled serial and with the ``chain_interleave`` pass, priced by the
   port's simulator (``simulate_baseline`` / ``simulate_unified``). They are
   a prediction of the Ascend A3 model, not a measurement of any device.
2. Kernel rows: both modes checked against their plain versions, then
   timed with CUDA events beside the H100 bound (each input read once, the
   output written once — plus g's round trip for serial — at 3.35 TB/s).
   On the CPU the rows carry the check only: "not measured".
"""

from __future__ import annotations

import argparse

import torch

from ..core.hardware import AscendA3
from ..core.hardware import H100
from ..core.scheduler import compile_schedule
from ..core.simulator import simulate_baseline, simulate_unified
from ..device import resolve_device
from ..kernels.ref import swiglu_add_ref, swiglu_add_serial_ref
from ..kernels.swiglu_add import swiglu_add_interleaved, swiglu_add_serial
from .bench_common import build_swiglu_add_odg, emit

PAPER = {32768: (723.29, 588.38, 0.0520, 0.2544)}  # serial_us, int_us, hits
SIM_SIZES = (8192, 16384, 32768)
WIDTH = 2048                       # F of y [M, F], h [M, 2F]: the paper's
ITERS, WARMUP = 20, 3              # timed calls after warm-up calls
# fp32 operations per output element: exp, add and reciprocal of the
# sigmoid, the two products, the add of y.
OPS_PER_ELEM = 6
# Kernel vs plain version: fp32 differs only by the order of a few
# elementwise operations; bf16 by one rounding (the JAX kernel tests' 2e-2).
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
MODES = {"serial": (swiglu_add_serial, swiglu_add_serial_ref),
         "interleaved": (swiglu_add_interleaved, swiglu_add_ref)}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def sim_rows(hw: AscendA3 = AscendA3()) -> list[dict]:
    """Serial (``simulate_baseline``) and ``chain_interleave``
    (``simulate_unified``) makespans on the Ascend A3 model, 128-row tiles."""
    rows = []
    for M in SIM_SIZES:
        n_tiles = M // 128          # fine AIV tiles (pool-width granularity)
        ser = simulate_baseline(
            compile_schedule(build_swiglu_add_odg(M, n_tiles)), hw)
        inter = simulate_unified(
            compile_schedule(build_swiglu_add_odg(M, n_tiles),
                             pipeline=["chain_interleave"]), hw)
        rows.append({"M": M, "serial_us": ser.makespan_us,
                     "interleaved_us": inter.makespan_us,
                     "l2_hit_serial": ser.l2_hit_rate,
                     "l2_hit_inter": inter.l2_hit_rate})
    return rows


def bound(M: int, F: int, dtype, mode: str) -> tuple[float, str]:
    """Least time (ms) of one call on an H100 and what sets it: h, y read
    once and out written once (serial: g written and read back too) at
    3.35 TB/s, against the fp32 operations at 67 TFLOP/s."""
    item = torch.finfo(dtype).bits // 8
    elems = M * F * (6 if mode == "serial" else 4)
    t_bytes = elems * item / H100.hbm_bytes_per_s
    t_ops = OPS_PER_ELEM * M * F / H100.peak_flops_fp32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check(mode: str, h, y) -> float:
    """Max |kernel − plain version| of ``mode`` on h, y; raises if any
    element is off by more than tol + tol·|plain|."""
    fn, plain = MODES[mode]
    got, want = fn(h, y).float(), plain(h, y).float()
    if tuple(got.shape) != tuple(y.shape) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"swiglu_add_{mode}: bad output "
                             f"{tuple(got.shape)}")
    err = (got - want).abs()
    tol = TOL[h.dtype]
    if not bool((err <= tol + tol * want.abs()).all()):
        raise AssertionError(f"swiglu_add_{mode} disagrees with its plain "
                             f"version at M={h.shape[0]}, F={y.shape[1]}, "
                             f"{h.dtype}: max |err| {float(err.max())}")
    return float(err.max())


def cuda_ms(fn) -> float:
    """Mean device time (ms) of ``fn()`` by CUDA events over ITERS calls
    after WARMUP calls."""
    for _ in range(WARMUP):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def inputs(M: int, F: int, dtype, dev, seed: int = 0):
    """h [M, 2F], y [M, F] of standard normals from ``seed``, on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn((M, 2 * F), generator=gen, device=dev).to(dtype)
    y = torch.randn((M, F), generator=gen, device=dev).to(dtype)
    return h, y


def kernel_rows(sizes, dev):
    """Check, and on the card time, both modes at each (dtype, M).

    Returns the rows and how many times each mode's wrapper was called on
    the card (every call launches: two kernels for serial, one for
    interleaved)."""
    rows, calls = [], {m: 0 for m in MODES}
    timed = dev.type == "cuda"
    for dname, dtype in DTYPES.items():
        for M in sizes:
            h, y = inputs(M, WIDTH, dtype, dev)
            for mode, (fn, plain) in MODES.items():
                row = {"mode": mode, "M": M, "F": WIDTH, "dtype": dname,
                       "max_abs_err": check(mode, h, y), "tol": TOL[dtype]}
                b_ms, b_by = bound(M, WIDTH, dtype, mode)
                row.update(bound_ms=b_ms, bound_by=b_by, ms=None,
                           plain_ms=None)
                if timed:
                    row["ms"] = cuda_ms(lambda: fn(h, y))
                    row["plain_ms"] = cuda_ms(lambda: plain(h, y))
                    calls[mode] += 1 + WARMUP + ITERS
                rows.append(row)
            del h, y
    return rows, calls


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", default=",".join(map(str, SIM_SIZES)),
                    help="comma-separated M of the kernel rows")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")

    print("name,us_per_call,derived")
    sims = sim_rows()
    for r in sims:
        derived = (f"prediction=ascend_a3_model "
                   f"interleaved={r['interleaved_us']:.1f}us "
                   f"speedup={r['serial_us'] / r['interleaved_us']:.2f}x "
                   f"l2_hit_serial={r['l2_hit_serial']:.3f} "
                   f"l2_hit_inter={r['l2_hit_inter']:.3f}")
        if r["M"] in PAPER:
            pb, pi, hs, hi = PAPER[r["M"]]
            derived += (f" paper:{pb:.0f}->{pi:.0f}us "
                        f"hits {hs:.3f}->{hi:.3f}")
        emit(f"swiglu_add_M{r['M']}_serial_sim", r["serial_us"], derived)

    sizes = [int(s) for s in args.sizes.split(",")]
    rows, calls = kernel_rows(sizes, dev)
    for r in rows:
        if r["ms"] is None:
            timing = "time=not_measured"
        else:
            timing = (f"plain={1e3 * r['plain_ms']:.2f}us "
                      f"x_bound={r['ms'] / r['bound_ms']:.2f}")
        emit(f"swiglu_add_kernel_{r['mode']}_{r['dtype']}_M{r['M']}",
             None if r["ms"] is None else 1e3 * r["ms"],
             f"allclose=ok max_abs_err={r['max_abs_err']:.3g} "
             f"h100_{r['bound_by']}_bound={1e3 * r['bound_ms']:.2f}us "
             f"{timing} device={name.replace(' ', '_')}")
    return {"device": name, "sim": sims, "kernels": rows, "calls": calls}


if __name__ == "__main__":
    main()
