"""Shared helpers of the port's benchmark twins — counterpart of
``benchmarks/common.py``.

Rows are CSV ``name,us_per_call,derived``. The schedules these helpers
build are priced by the port's simulator on the Ascend A3 model: their µs
are predictions of that model, not times of the H100.
"""

from __future__ import annotations

from ..core.odg import (ODG, OperatorNode, ScheduleConfig, SplitSpec,
                        VECTOR, build_moe_ffn_backward,
                        build_moe_ffn_forward)
from ..core.scheduler import compile_schedule

CSV_HEADER = "name,us_per_call,derived"


def emit(name: str, us, derived: str = "") -> None:
    """One CSV row; ``us`` None leaves the column empty (not measured)."""
    print(f"{name},{'' if us is None else f'{us:.2f}'},{derived}",
          flush=True)


def phase_summary(sim) -> str:
    """Space-separated per-phase busy-time breakdown of a ``SimResult``.

    Pairs with the ``dispatch_to_combine_us`` span to show *where* the
    busy time between the first dispatch and the last combine goes
    (comma-free, so it fits a single CSV ``derived`` cell).
    """
    order = ("dispatch", "gmm", "vector", "combine", "boundary")
    parts = [f"{ph}={sim.phase_us[ph]:.1f}us"
             for ph in order if ph in sim.phase_us]
    parts += [f"{ph}={us:.1f}us" for ph, us in sorted(sim.phase_us.items())
              if ph not in order]
    return " ".join(parts)


def paper_module_config(ep: int, *, m_split_mult: int = 4) -> ScheduleConfig:
    """The §5.2 DeepSeek-style MoE-FFN module, per-device effective shapes.

    seq 4096 × microbatch 2 = 8192 tokens/rank, top-8, 8 local experts,
    hidden 7168, expert intermediate 2048 (→1024 per device under TP2).
    """
    e_loc = 8
    rows = 8192 * 8 // (ep * e_loc)
    return ScheduleConfig(ep=ep, e_loc=e_loc, rows=rows, d_model=7168,
                          d_ff=1024, gmm_m_split=ep * m_split_mult)


def opt_pipeline(direction: str) -> list:
    """The paper's §4.5 optimization set as a schedule-pass pipeline."""
    return (["ratr", "gmm_interleave"] if direction == "backward"
            else ["ratr"])


def ffn_graph(direction: str):
    """The forward or backward MoE-FFN graph's build function."""
    return (build_moe_ffn_forward if direction == "forward"
            else build_moe_ffn_backward)


def compiled_pair(ep: int, direction: str):
    """(baseline, optimised) schedules of the paper's module: one GMM tile
    a rank and no pass, against 4·ep tiles under :func:`opt_pipeline`."""
    build = ffn_graph(direction)
    base = compile_schedule(build(paper_module_config(ep, m_split_mult=1)))
    opt = compile_schedule(build(paper_module_config(ep)),
                           pipeline=opt_pipeline(direction))
    return base, opt


def build_swiglu_add_odg(M: int, n_tiles: int, width_in: int = 4096,
                         width_out: int = 2048) -> ODG:
    """§6 microbenchmark workload: SwiGLU → Add over [M, width] rows."""
    cfg = ScheduleConfig(ep=1, e_loc=1, rows=M, d_model=width_in // 2,
                         d_ff=width_out, gmm_m_split=n_tiles)
    g = ODG(cfg, "forward")
    h = g.tensor("h@0", M, width_in * 2, external=True)
    y = g.tensor("y@0", M, width_out * 2, external=True)
    mid = g.tensor("g@0", M, width_out * 2)
    out = g.tensor("out@0", M, width_out * 2)

    n_fn = (lambda c, op: n_tiles)
    g.add_op(OperatorNode(
        name="SwiGLU@0", op_type="swiglu", resource=VECTOR, rank=0,
        inputs=[h], outputs=[mid],
        split_spec=SplitSpec(split_inputs=None, split_output_dims=(0,),
                             task_num_fn=n_fn)))
    g.add_op(OperatorNode(
        name="Add@0", op_type="elementwise", resource=VECTOR, rank=0,
        inputs=[mid, y], outputs=[out],
        split_spec=SplitSpec(split_inputs=((0, 0),), split_output_dims=(0,),
                             task_num_fn=n_fn),
        meta={"task_type": "Add"}))
    g.validate_acyclic()
    return g
