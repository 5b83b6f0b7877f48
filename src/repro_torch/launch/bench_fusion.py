"""Cross-layer schedule fusion, fused vs back-to-back fragment makespan —
counterpart of ``benchmarks/bench_fusion.py`` on the port's ``core/``.

Host-only: every number is the discrete-event simulator's makespan on the
Ascend A3 model (``core.hardware.AscendA3``), a prediction for that
hardware, not a measurement of any device. Its rows equal the reference's.

    PYTHONPATH=src python -m repro_torch.launch.bench_fusion

It compiles a two-layer fused forward taskflow (layer 0's combine bridged
into layer 1's dispatch through per-rank LayerBoundary tiles) for three
routing-skew scenarios and simulates it twice with identical tasks and
costs: **fused**, the cross-fragment edges as compiled, and
**sequential**, the same taskflow under ``fragment_barrier=True`` (fragment
1 waits until fragment 0 drains). The fused dispatch-to-combine span must
beat the barrier's on at least two of the three scenarios, or the run
raises. Each layer's standalone span, doubled, is emitted as context.

The PP section compiles the same scenarios as a 1F1B-interleaved pipeline
(``compile_pp_fused``, ep = 8, S in ``PP_STAGES``, per-device shapes of a
Megatron tp2pp4ep4 slice) and simulates fused against
``stage_barrier=True``. Fused must beat the barrier on dispatch-to-combine
or makespan on two of three scenarios per depth, and ``select_pp`` must
never predict fused worse than per-stage.

Rows are CSV ``name,us_per_call,derived``.
"""

from __future__ import annotations

from ..core.autoselect import select_pp
from ..core.fusion import compile_fused, compile_pp_fused
from ..core.hardware import AscendA3
from ..core.odg import ScheduleConfig, build_moe_ffn_forward
from ..core.routing import hotspot_plan, skewed_plan
from ..core.scheduler import compile_schedule
from ..core.simulator import simulate_unified
from .bench_common import emit

EP, E_LOC, ROWS = 8, 8, 128
D_MODEL, D_FF = 2048, 512
M_SPLIT = 64
PIPELINE = ["ratr", "critical_rank_first"]
WINS_REQUIRED = 2

# PP scenario: per-device slice of a Megatron tp2pp4ep4 run — d_model and
# d_ff/tp in their ~1.75 ratio (14336 / 4096 / 2tp), modest rows and
# m_split so the S x M cell grid stays simulation-sized.
PP_D_MODEL, PP_D_FF = 1024, 1792
PP_ROWS, PP_M_SPLIT = 64, 32
PP_MICROBATCHES = 4
PP_STAGES = (2, 4)


def _cases():
    yield "uniform", skewed_plan(EP, E_LOC, ROWS, 0.0)
    yield "zipf", skewed_plan(EP, E_LOC, ROWS, 1.2)
    yield "hotspot", hotspot_plan(EP, E_LOC, ROWS, background=16)


def _cfg(plan) -> ScheduleConfig:
    return ScheduleConfig(ep=EP, e_loc=E_LOC, rows=0, d_model=D_MODEL,
                          d_ff=D_FF, gmm_m_split=M_SPLIT,
                          gmm_split_mode="source_aligned", plan=plan)


def _pp_cfg(plan) -> ScheduleConfig:
    return ScheduleConfig(ep=EP, e_loc=E_LOC, rows=0, d_model=PP_D_MODEL,
                          d_ff=PP_D_FF, gmm_m_split=PP_M_SPLIT,
                          gmm_split_mode="source_aligned", plan=plan)


def _pp_cases():
    yield "uniform", skewed_plan(EP, E_LOC, PP_ROWS, 0.0)
    yield "zipf", skewed_plan(EP, E_LOC, PP_ROWS, 1.2)
    yield "hotspot", hotspot_plan(EP, E_LOC, PP_ROWS, background=8)


def run_pp(hw: AscendA3 = AscendA3()) -> list[tuple]:
    """The PP section's rows ``(name, us, derived)``, each also emitted."""
    rows = []

    def out(*row):
        rows.append(row)
        emit(*row)

    for S in PP_STAGES:
        wins = 0
        for name, plan in _pp_cases():
            cfg = _pp_cfg(plan)
            fs = compile_pp_fused([cfg] * S, PP_MICROBATCHES,
                                  pipeline=PIPELINE)
            fsim = simulate_unified(fs, hw)
            ssim = simulate_unified(fs, hw, stage_barrier=True)
            won = (fsim.dispatch_to_combine_us < ssim.dispatch_to_combine_us
                   or fsim.makespan_us < ssim.makespan_us)
            wins += won
            win_pct = ((ssim.makespan_us - fsim.makespan_us)
                       / max(1e-9, ssim.makespan_us) * 100)
            out(f"pp{S}_{name}_fused", fsim.makespan_us,
                f"win={win_pct:+.2f}% d2c={fsim.dispatch_to_combine_us:.1f}"
                f"us cells={S}x{PP_MICROBATCHES} "
                f"stage_comm={fsim.phase_us.get('stage', 0.0):.1f}us")
            out(f"pp{S}_{name}_stage_barrier", ssim.makespan_us,
                f"barrier=stage d2c={ssim.dispatch_to_combine_us:.1f}us "
                f"plan_skew={plan.expert_imbalance():.2f}x")
            ch = select_pp([cfg] * S, PP_MICROBATCHES)
            if ch.predicted_fused_us > ch.predicted_per_stage_us + 1e-9:
                raise RuntimeError(
                    f"select_pp predicted fused worse than per-stage at "
                    f"pp={S} scenario={name}: {ch.predicted_fused_us:.1f}us"
                    f" > {ch.predicted_per_stage_us:.1f}us")
            out(f"pp{S}_{name}_selector_fused_pred", ch.predicted_fused_us,
                f"per_stage_pred={ch.predicted_per_stage_us:.1f}us "
                f"bubble={ch.bubble_us:.1f}us fuse={ch.fuse}")
        out(f"pp{S}_scenario_wins", float(wins),
            f"required>={WINS_REQUIRED}of3")
        if wins < WINS_REQUIRED:
            raise RuntimeError(
                f"PP-fused schedule beat the stage-barrier reference on "
                f"only {wins}/3 scenarios at pp={S} "
                f"(need >= {WINS_REQUIRED})")
    return rows


def run(hw: AscendA3 = AscendA3()) -> list[tuple]:
    """Every row ``(name, us, derived)``, each also emitted; raises where
    the reference's gates do."""
    rows = []

    def out(*row):
        rows.append(row)
        emit(*row)

    wins = 0
    for name, plan in _cases():
        cfg = _cfg(plan)
        fused = compile_fused([cfg, cfg], "forward", pipeline=PIPELINE)
        fsim = simulate_unified(fused, hw)
        ssim = simulate_unified(fused, hw, fragment_barrier=True)
        solo = simulate_unified(
            compile_schedule(build_moe_ffn_forward(cfg), pipeline=PIPELINE),
            hw)
        f_d2c, s_d2c = (fsim.dispatch_to_combine_us,
                        ssim.dispatch_to_combine_us)
        win_pct = (s_d2c - f_d2c) / max(1e-9, s_d2c) * 100
        won = f_d2c < s_d2c
        wins += won
        out(f"fusion_{name}_fused", f_d2c,
            f"win={win_pct:+.2f}% frag0="
            f"{fsim.fragment_makespan_us.get(0, 0.0):.1f}us frag1="
            f"{fsim.fragment_makespan_us.get(1, 0.0):.1f}us "
            f"boundary_busy={fsim.phase_us.get('boundary', 0.0):.1f}us")
        out(f"fusion_{name}_sequential", s_d2c,
            f"barrier=fragment plan_skew={plan.expert_imbalance():.2f}x")
        out(f"fusion_{name}_per_layer_x2", 2 * solo.dispatch_to_combine_us,
            "context=host-bridge remap (unpriced boundary)")
    out("fusion_scenario_wins", float(wins), f"required>={WINS_REQUIRED}of3")
    if wins < WINS_REQUIRED:
        raise RuntimeError(
            f"fused schedule beat the fragment-barrier reference on only "
            f"{wins}/3 scenarios (need >= {WINS_REQUIRED})")
    return rows + run_pp(hw)


if __name__ == "__main__":
    run()
