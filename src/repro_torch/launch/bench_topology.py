"""Topology-aware hierarchical EP — two-level vs flat dispatch latency —
counterpart of ``benchmarks/bench_topology.py``.

    PYTHONPATH=src python -m repro_torch.launch.bench_topology

Compiles each skew scenario twice against a 2-node cluster (ep = 8, 4
ranks a node, 350 GB/s intra vs 50 GB/s inter links) and simulates both
with the same topology-aware cost model: ``flat`` (one put per nonzero
cell, each cross-node cell paying its own hop) and ``hier``
(``dispatch_mode="hier"``: latency-bound cross-node groups gather at a
node leader and take the slow hop as one message). The int8-compressed
inter-node variant and the cost-model selector's pick are context.

Gates (``RuntimeError``): hier must beat flat on at least WINS_REQUIRED of
the three scenarios, and the selector must never pick a candidate
predicted worse than the best flat one. Every µs of a row is the port's
simulator on the Ascend A3 model, a prediction, not a time of the H100 or
of any device.
"""

from __future__ import annotations

from ..core import autoselect
from ..core.costmodel import CostModel
from ..core.hardware import AscendA3, Topology
from ..core.odg import ScheduleConfig, build_moe_ffn_forward
from ..core.routing import hotspot_plan, node_limited_plan, skewed_plan
from ..core.scheduler import compile_schedule
from ..core.simulator import simulate_unified
from .bench_common import emit

EP, E_LOC, ROWS = 8, 8, 16
D_MODEL, D_FF = 1024, 256
M_SPLIT = 4
TOPO = Topology(ranks_per_node=4, intra_gbps=350.0, inter_gbps=50.0,
                intra_hop_us=0.35, inter_hop_us=2.0)
PIPELINE = ["ratr", "hier_dispatch"]
WINS_REQUIRED = 2


def _cases():
    yield "zipf", skewed_plan(EP, E_LOC, ROWS, 1.6)
    yield "hotspot", hotspot_plan(EP, E_LOC, ROWS, background=2)
    yield "node_limited", node_limited_plan(EP, E_LOC, ROWS,
                                            node_size=TOPO.ranks_per_node)


def _cfg(plan, **kw) -> ScheduleConfig:
    return ScheduleConfig(ep=EP, e_loc=E_LOC, rows=0, d_model=D_MODEL,
                          d_ff=D_FF, gmm_m_split=M_SPLIT,
                          gmm_split_mode="source_aligned", plan=plan,
                          topology=TOPO, **kw)


def _d2c(cfg, hw, cost):
    s = compile_schedule(build_moe_ffn_forward(cfg), pipeline=PIPELINE)
    return simulate_unified(s, hw, cost=cost)


def run(hw: AscendA3 = AscendA3()) -> list[tuple]:
    """Every row ``(name, us, derived)``, each also emitted; raises
    ``RuntimeError`` where a gate fails."""
    cost = CostModel(hw=hw, topology=TOPO)
    rows, wins = [], 0
    for name, plan in _cases():
        flat = _d2c(_cfg(plan), hw, cost)
        hier = _d2c(_cfg(plan, dispatch_mode="hier"), hw, cost)
        hier_c = _d2c(_cfg(plan, dispatch_mode="hier",
                           xnode_compress="int8"), hw, cost)
        f, h = flat.dispatch_to_combine_us, hier.dispatch_to_combine_us
        win_pct = (f - h) / max(1e-9, f) * 100
        wins += h < f
        rows += [
            (f"topology_{name}_flat", f,
             f"inter_busy={flat.link_us.get('inter', 0.0):.1f}us "
             f"intra_busy={flat.link_us.get('intra', 0.0):.1f}us"),
            (f"topology_{name}_hier", h,
             f"win={win_pct:+.2f}% "
             f"inter_busy={hier.link_us.get('inter', 0.0):.1f}us "
             f"intra_busy={hier.link_us.get('intra', 0.0):.1f}us"),
            (f"topology_{name}_hier_int8", hier_c.dispatch_to_combine_us,
             f"context=inter-node wire bytes halved "
             f"inter_busy={hier_c.link_us.get('inter', 0.0):.1f}us")]
        for row in rows[-3:]:
            emit(*row)

        # Selector contract: with a Topology in the config, auto-selection
        # prices flat and hier candidates on the same per-link-class model
        # and must never pick one predicted worse than the best flat.
        choice = autoselect.select(None, _cfg(plan))
        flat_best = min(s.predicted_us for s in choice.scores
                        if s.cfg.dispatch_mode == "flat")
        rows.append((f"topology_{name}_auto_pred", choice.predicted_us,
                     f"pick={choice.tag} flat_best={flat_best:.1f}us"))
        emit(*rows[-1])
        if choice.predicted_us > flat_best:
            raise RuntimeError(
                f"auto-selection picked {choice.tag} predicted at "
                f"{choice.predicted_us:.1f}us, worse than the best flat "
                f"candidate ({flat_best:.1f}us) on scenario {name!r}")
    rows.append(("topology_scenario_wins", float(wins),
                 f"required>={WINS_REQUIRED}of3"))
    emit(*rows[-1])
    if wins < WINS_REQUIRED:
        raise RuntimeError(
            f"hierarchical dispatch beat flat on only {wins}/3 skew "
            f"scenarios (need >= {WINS_REQUIRED})")
    return rows


if __name__ == "__main__":
    run()
