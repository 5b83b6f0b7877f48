"""Routing-skew sweep — what load imbalance costs each execution mode —
counterpart of ``benchmarks/bench_imbalance.py``.

    PYTHONPATH=src python -m repro_torch.launch.bench_imbalance

Sweeps a Zipf-like skew factor over global experts (ALPHAS; token count
held constant) plus two hotspot profiles, compiles the forward taskflow
from the resulting RoutingPlan under source-aligned sub-splitting, and runs
it through both simulators:

* unified (pipeline ``ratr``) vs the operator-by-operator baseline;
* ``ratr`` vs ``ratr + critical_rank_first``, what the straggler-aware
  pass recovers at compile time.

Every µs of a row is the port's simulator on the Ascend A3 model, a
prediction, not a time of the H100 or of any device.
"""

from __future__ import annotations

from ..core.hardware import AscendA3
from ..core.odg import ScheduleConfig, build_moe_ffn_forward
from ..core.routing import hotspot_plan, skewed_plan
from ..core.scheduler import compile_schedule
from ..core.simulator import simulate_baseline, simulate_unified
from .bench_common import emit, phase_summary

EP, E_LOC, ROWS = 8, 8, 128
D_MODEL, D_FF = 2048, 512
M_SPLIT = 64
ALPHAS = (0.0, 0.5, 1.0, 2.0)


def _cases():
    for alpha in ALPHAS:
        yield f"alpha{alpha:g}", skewed_plan(EP, E_LOC, ROWS, alpha)
    yield "hotspot", hotspot_plan(EP, E_LOC, ROWS)
    yield "hotspot_bg", hotspot_plan(EP, E_LOC, ROWS, background=16)


def run(hw: AscendA3 = AscendA3()) -> list[tuple]:
    """Every row ``(name, us, derived)``, each also emitted."""
    rows = []
    for name, plan in _cases():
        # Source-aligned sub-splitting: legal for arbitrary skewed plans,
        # where the even grid compiles only per-src-uniform ones.
        cfg = ScheduleConfig(ep=EP, e_loc=E_LOC, rows=0, d_model=D_MODEL,
                             d_ff=D_FF, gmm_m_split=M_SPLIT,
                             gmm_split_mode="source_aligned", plan=plan)
        sched = compile_schedule(build_moe_ffn_forward(cfg),
                                 pipeline=["ratr"])
        crit_sched = compile_schedule(
            build_moe_ffn_forward(cfg),
            pipeline=["ratr", "critical_rank_first"])
        uni = simulate_unified(sched, hw)
        crit = simulate_unified(crit_sched, hw)
        base = simulate_baseline(sched, hw)
        cut = ((uni.makespan_us - crit.makespan_us)
               / max(1e-9, uni.makespan_us) * 100)
        rows += [
            (f"imbalance_{name}_unified", uni.makespan_us,
             f"straggler={uni.straggler_ratio:.2f}x "
             f"mac={uni.mac_ratio:.3f} "
             f"exposed={uni.exposed_comm_us:.1f}us "
             f"plan_skew={plan.expert_imbalance():.2f}x"),
            (f"imbalance_{name}_d2c", uni.dispatch_to_combine_us,
             phase_summary(uni)),
            (f"imbalance_{name}_crit_first", crit.makespan_us,
             f"reduction={cut:+.2f}% vs_ratr={uni.makespan_us:.1f}us"),
            (f"imbalance_{name}_baseline", base.makespan_us,
             f"straggler={base.straggler_ratio:.2f}x "
             f"speedup={base.makespan_us / max(1e-9, uni.makespan_us):.2f}x")]
        for row in rows[-4:]:
            emit(*row)
    return rows


if __name__ == "__main__":
    run()
