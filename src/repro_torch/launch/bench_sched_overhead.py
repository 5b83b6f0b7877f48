"""Figure 10 — static vs dynamic scheduling overhead on taskized
SwiGLU + Add — counterpart of ``benchmarks/bench_sched_overhead.py``.

    PYTHONPATH=src python -m repro_torch.launch.bench_sched_overhead

Both paths run the same tile taskflow with the same event dependencies;
the only difference is the per-task dispatch cost on the device's critical
path: 0.1 µs (precompiled SSC consumption) vs 2.36 µs (online dependency
checking + task selection), the paper's §6.2 numbers. Every µs of a row is
the port's simulator on the Ascend A3 model, a prediction, not a time of
the H100 or of any device.
"""

from __future__ import annotations

from ..core.hardware import AscendA3
from ..core.scheduler import compile_schedule
from ..core.simulator import simulate_unified
from .bench_common import build_swiglu_add_odg, emit

SIZES = (2048, 8192, 32768)
N_TILES = 128                   # fixed fine AIV tiling (§6.2 regime)
PAPER = {2048: (413.00, 54.00), 32768: (862.80, 588.38)}


def run(hw: AscendA3 = AscendA3()) -> list[tuple]:
    """Every row ``(name, us, derived)``, each also emitted."""
    rows = []
    for M in SIZES:
        static = simulate_unified(
            compile_schedule(build_swiglu_add_odg(M, N_TILES)), hw,
            dispatch_overhead_us=hw.static_dispatch_us)
        dyn = simulate_unified(
            compile_schedule(build_swiglu_add_odg(M, N_TILES)), hw,
            dispatch_overhead_us=hw.dynamic_dispatch_us,
            serialize_dispatch=True)
        derived = (f"static={static.makespan_us:.1f}us "
                   f"ratio={dyn.makespan_us / static.makespan_us:.2f}x")
        if M in PAPER:
            pd, ps = PAPER[M]
            derived += f" paper:{pd:.0f}us/{ps:.0f}us={pd / ps:.2f}x"
        rows.append((f"sched_overhead_M{M}_dynamic", dyn.makespan_us,
                     derived))
        emit(*rows[-1])
    return rows


if __name__ == "__main__":
    run()
