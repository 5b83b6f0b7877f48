"""Table 3 / Figure 7 — Dispatch-to-Combine MoE-FFN latency, EP ∈ EPS —
counterpart of ``benchmarks/bench_moe_ffn.py``.

    PYTHONPATH=src python -m repro_torch.launch.bench_moe_ffn

Runs the compiled schedules (the same objects the port's executor
validates) through the discrete-event Ascend A3 model: the baseline is the
operator-by-operator collective path, HyperParallel-MoE the unified
CTQ/VTQ taskflow with RATR + backward GMM interleaving. Every µs of a row
is a prediction of that model, not a time of the H100 or of any device.
"""

from __future__ import annotations

from ..core.hardware import AscendA3
from ..core.simulator import simulate_baseline, simulate_unified
from .bench_common import compiled_pair, emit, phase_summary

EPS = (4, 8, 16)
PAPER = {  # (baseline_ms, ours_ms) from Table 3
    (4, "fwd"): (16.3, 10.2), (4, "bwd"): (27.9, 19.4),
    (8, "fwd"): (17.3, 10.3), (8, "bwd"): (29.8, 19.6),
    (16, "fwd"): (18.4, 11.2), (16, "bwd"): (30.5, 19.9),
}


def run(hw: AscendA3 = AscendA3()) -> list[tuple]:
    """Every row ``(name, us, derived)``, each also emitted."""
    rows = []
    for ep in EPS:
        tot_b, tot_u = 0.0, 0.0
        for direction, tag in (("forward", "fwd"), ("backward", "bwd")):
            s_base, s_opt = compiled_pair(ep, direction)
            b = simulate_baseline(s_base, hw)
            u = simulate_unified(s_opt, hw)
            tot_b += b.makespan_us
            tot_u += u.makespan_us
            pb, pu = PAPER[(ep, tag)]
            rows += [
                (f"moe_ffn_ep{ep}_{tag}_baseline", b.makespan_us,
                 f"paper={pb}ms mac={b.mac_ratio:.2f}"),
                (f"moe_ffn_ep{ep}_{tag}_hyperparallel", u.makespan_us,
                 f"paper={pu}ms mac={u.mac_ratio:.2f} "
                 f"speedup={b.makespan_us / u.makespan_us:.2f}x "
                 f"paper_speedup={pb / pu:.2f}x"),
                (f"moe_ffn_ep{ep}_{tag}_d2c", u.dispatch_to_combine_us,
                 phase_summary(u))]
            for row in rows[-3:]:
                emit(*row)
        (fb, fu), (bb, bu) = PAPER[(ep, "fwd")], PAPER[(ep, "bwd")]
        rows.append((f"moe_ffn_ep{ep}_total_speedup", 0.0,
                     f"{tot_b / tot_u:.2f}x (paper "
                     f"{(fb + bb) / (fu + bu):.2f}x)"))
        emit(*rows[-1])
    return rows


if __name__ == "__main__":
    run()
