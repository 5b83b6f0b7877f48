"""Compile-time per-task cost model — one timing formula for the whole stack.

The discrete-event simulator (``core/simulator.py``) and the schedule-pass
pipeline (``core/passes.py``) both need to price a :class:`TaskDescriptor`:
the simulator to advance its clocks, the passes to make placement and
ordering decisions *at compile time* (Hexa-MoE-style: heterogeneity-aware
cost estimates drive decisions before any simulation runs). Keeping one
``CostModel`` here is what guarantees the two never disagree — the simulator
owns the L2 *state* (which tiles are resident) but delegates every duration
to :meth:`CostModel.task_us`.

The L2-residency term is optional: passes that run before any execution
order exists have no residency information, so they price tasks with
``CostModel(l2=False)`` — the HBM-streaming lower bound. The simulator keeps
``l2=True`` and supplies the hit fraction it observes.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Optional

from .hardware import AscendA3, Topology
from .odg import CTQ


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Prices one tile task on its execution unit (excl. queue overhead)."""

    hw: AscendA3 = AscendA3()
    # Model operand L2 residency. When False, the ``l2_hit_frac`` argument is
    # ignored and every input streams from HBM — the deterministic estimate
    # compile-time passes use.
    l2: bool = True
    # Optional cluster topology: remote transfers are then priced per link
    # class (intra-node vs inter-node bandwidth and latency) instead of the
    # flat ``hw.link_gbps`` / ``hw.hop_latency_us``.
    topology: Optional[Topology] = None
    # Observed per-rank slowdown factors (mean ≈ 1.0), fed back from the
    # training loop's straggler watchdog (``ft.runner`` records per-rank
    # step-time EWMAs; ``core.elastic.observed_cost_model`` normalizes them
    # into this tuple). Every task executing on rank ``r`` is priced
    # ``rank_bias[r]×`` slower, so a persistently slow rank becomes the
    # compile-time critical rank that ``critical_rank_first`` and
    # ``autoselect`` schedule around. A tuple (not a list) so the model
    # stays frozen/hashable — it is part of the selector's memo key.
    rank_bias: Optional[tuple] = None

    def _bias(self, rank: int) -> float:
        if self.rank_bias is None or not 0 <= rank < len(self.rank_bias):
            return 1.0
        return self.rank_bias[rank]

    def link_class_of(self, td) -> str:
        """Link class of a put task: local / intra / inter, or the flat
        ``"link"`` when no topology is attached (incl. multi-dst fallback
        tasks, whose destinations are unknown). ``StageBoundary`` tiles
        always ride the pipeline-stage link — the topology's inter-node
        class — regardless of rank indices (the downstream stage is a
        different device that happens to share the EP rank index)."""
        if td.task_type == "StageBoundary":
            return "inter" if self.topology is not None else "link"
        if td.dst_rank == td.src_rank:
            return "local"
        if self.topology is None or td.dst_rank < 0:
            return "link"
        return self.topology.link_class(td.src_rank, td.dst_rank)

    def task_us(self, td, l2_hit_frac: float = 0.0) -> float:
        """Execution time of one TD in microseconds.

        ``l2_hit_frac`` is the row-weighted fraction of the task's inputs
        resident in L2 (supplied by the simulator's LRU model; 0.0 for
        compile-time estimates). With ``rank_bias`` set, the result scales
        by the executing rank's observed slowdown factor.
        """
        return self._bias(td.rank) * self._task_us_unbiased(td, l2_hit_frac)

    def _task_us_unbiased(self, td, l2_hit_frac: float = 0.0) -> float:
        hw = self.hw
        frac = l2_hit_frac if self.l2 else 0.0
        if td.task_type == "put_mem_signal":
            t = 0.0
            if td.meta.get("compress"):
                # Quantize at the sender + dequantize at the receiver:
                # two L2-resident streaming passes over the full-precision
                # payload. ``comm_bytes`` already reflects the wire size.
                t += ((td.read_bytes + td.write_bytes)
                      / (hw.l2_read_x_hbm * hw.hbm_gbps * 1e3))
            cls = self.link_class_of(td)
            if cls == "local":
                # Rank-local "transfer" is an HBM copy, not link traffic.
                return t + td.comm_bytes / (hw.hbm_gbps * 1e3)
            if cls == "link":
                return (t + hw.hop_latency_us
                        + td.comm_bytes / (hw.link_gbps * 1e3))
            topo = self.topology
            return (t + topo.latency_us(cls)
                    + td.comm_bytes / (topo.bw_gbps(cls) * 1e3))
        if td.task_type == "StageBoundary":
            # PP activation handoff: the payload crosses the stage link.
            # No L2 term — the tile is link-bound, not bandwidth-from-HBM
            # bound, and no ``local`` case: the downstream stage is always
            # a different device.
            cls = self.link_class_of(td)
            if cls == "link":
                return (hw.hop_latency_us
                        + td.comm_bytes / (hw.link_gbps * 1e3))
            topo = self.topology
            return (topo.latency_us(cls)
                    + td.comm_bytes / (topo.bw_gbps(cls) * 1e3))
        if td.queue_type == CTQ:
            # Per-tile GMM efficiency depends on operand L2 residency — the
            # mechanism cache-guided interleaving exploits (§4.5).
            eff_util = (hw.aic_eff_hbm
                        + (hw.aic_eff_l2 - hw.aic_eff_hbm) * frac)
            eff = hw.aic_tflops_bf16 * 1e12 * eff_util
            return td.flops / eff * 1e6
        # Vector task: read bandwidth depends on L2 residency of inputs.
        rb = td.read_bytes
        hit_bytes = rb * frac
        miss_bytes = rb - hit_bytes
        eff_bytes = (miss_bytes + hit_bytes / hw.l2_read_x_hbm
                     + td.write_bytes)
        return eff_bytes / (hw.aiv_gbps * 1e3)

    # -- schedule-level aggregates (compile-time skew diagnostics) -----------

    def rank_cube_us(self, sched) -> dict[int, float]:
        """Total estimated CTQ (cube) time per rank over the full EP group.

        Every rank of ``sched.ep`` appears, including ranks the plan starved
        of work — they must drag the mean down, exactly as the simulator's
        ``straggler_ratio`` counts them.
        """
        loads: dict[int, float] = defaultdict(float)
        for td in sched.tasks:
            if td.queue_type == CTQ:
                loads[td.rank] += self.task_us(td)
        return {r: loads.get(r, 0.0) for r in range(sched.ep)}

    def critical_rank(self, sched) -> tuple[float, int]:
        """(max/mean cube load, most-loaded rank) — the compile-time analogue
        of ``SimResult.straggler_ratio``/``critical_rank``."""
        loads = self.rank_cube_us(sched)
        if not loads:
            return 1.0, -1
        mean = sum(loads.values()) / len(loads)
        crit = max(loads, key=loads.get)
        return (loads[crit] / mean if mean > 0 else 1.0), crit

    # -- multi-fragment aggregates (fused schedules, core/fusion.py) ---------

    def fragment_rank_cube_us(self, sched) -> dict[int, dict[int, float]]:
        """Per-fragment cube load: {fragment index: {rank: us}}.

        Fragments are identified by ``meta["fragment"]`` (0 for every task
        of an unfused schedule, so this degenerates to one entry equal to
        :meth:`rank_cube_us`).
        """
        loads: dict[int, dict[int, float]] = defaultdict(
            lambda: defaultdict(float))
        frags: set[int] = set()
        for td in sched.tasks:
            f = td.meta.get("fragment", 0)
            frags.add(f)
            if td.queue_type == CTQ:
                loads[f][td.rank] += self.task_us(td)
        return {f: {r: loads[f].get(r, 0.0) for r in range(sched.ep)}
                for f in sorted(frags)}

    def pp_bubble_us(self, sched) -> float:
        """Compile-time 1F1B bubble estimate of a PP-fused schedule.

        The warm-up + cool-down idle of a synchronous pipeline is
        ``(n_stages - 1)`` slots of the bottleneck cell's pool-bound time —
        exactly the gap StageBoundary handoffs and EP dispatch/combine can
        be absorbed into. Cells are identified by ``pp_stage`` /
        ``pp_microbatch`` task metadata; returns 0.0 for schedules without
        it. Pool-bound: a cell's cube work spreads over ``num_aic`` cores
        and its vector work over ``num_aiv``, so the slot time is the
        slower pool, not the serial task sum.
        """
        cells: dict[tuple[int, int], list[float]] = defaultdict(
            lambda: [0.0, 0.0])
        for td in sched.tasks:
            s = td.meta.get("pp_stage")
            if s is None:
                continue
            c = cells[(s, td.meta.get("pp_microbatch", 0))]
            if td.queue_type == CTQ:
                c[0] += self.task_us(td)
            elif td.task_type not in ("put_mem_signal", "StageBoundary"):
                c[1] += self.task_us(td)
        if not cells:
            return 0.0
        hw = self.hw
        n_stages = len({s for (s, _) in cells})
        slot = max(max(cube / hw.num_aic, vec / hw.num_aiv)
                   for cube, vec in cells.values())
        return (n_stages - 1) * slot

    def fragment_critical_ranks(self, sched) -> dict[int, tuple[float, int]]:
        """Per-fragment (straggler ratio, critical rank) — each fused
        fragment carries its own plan, so its straggler is its own."""
        out: dict[int, tuple[float, int]] = {}
        for f, loads in self.fragment_rank_cube_us(sched).items():
            if not loads:
                out[f] = (1.0, -1)
                continue
            mean = sum(loads.values()) / len(loads)
            crit = max(loads, key=loads.get)
            out[f] = ((loads[crit] / mean if mean > 0 else 1.0), crit)
        return out
