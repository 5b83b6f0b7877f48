"""Discrete-event model of the unified AIC/AIV runtime (§4.4) on Ascend A3.

The container has no Ascend (or TPU) hardware, so the paper's latency tables
are reproduced *structurally*: the simulator executes real compiled schedules
(the same ``Schedule`` objects the executor validates numerically) against a
hardware model built from the paper's constants (``hardware.AscendA3``).

Two execution modes:

* ``simulate_unified`` — the HyperParallel-MoE runtime: per-rank AIC/AIV
  worker pools fetch CTQ/VTQ entries in order, block on dependent event
  counters, drive one-sided transfers over per-rank egress/ingress links,
  and share an LRU-modelled L2 between producer and consumer tiles.
* ``simulate_baseline`` — the conventional operator-by-operator path:
  per-op full-device kernels with launch gaps, host-synchronized collective
  AllToAll, and strict AIC/AIV alternation.

Per-tile GMM efficiency is identical in both modes — the baseline's low
observed MAC ratio *emerges* from idle alternation, it is not assumed.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import OrderedDict, defaultdict

from .costmodel import CostModel
from .hardware import AscendA3
from .odg import CTQ, VTQ
from .scheduler import Schedule, ScheduleError
from .tasks import NO_EVENT, TaskDescriptor


@dataclasses.dataclass
class SimResult:
    makespan_us: float
    busy_us: dict            # (rank, pool) -> busy time
    mac_ratio: float         # cube busy / (makespan * n_pools) across ranks
    exposed_comm_us: float   # time when comm is in flight but no cube busy
    l2_hits: int
    l2_lookups: int
    timeline: list           # (start, end, rank, pool, op_name)
    # Skew diagnostics (imbalanced RoutingPlans): how much longer the most
    # loaded rank's cube stays busy than the average rank's — the straggler
    # a load-imbalanced MoE batch creates even with perfect overlap.
    straggler_ratio: float = 1.0     # max / mean per-rank cube busy time
    critical_rank: int = -1          # rank with the largest cube busy time
    # Paper headline metrics: busy time per phase kind (dispatch / gmm /
    # vector / combine, plus boundary for fused schedules) and the explicit
    # dispatch-to-combine span — first dispatch byte in flight to last
    # combine byte landed.
    phase_us: dict = dataclasses.field(default_factory=dict)
    dispatch_to_combine_us: float = 0.0
    # Multi-fragment schedules: execution-position index -> wall-clock span
    # of that fragment's tasks. Overlap shows up as spans summing to more
    # than the makespan.
    fragment_makespan_us: dict = dataclasses.field(default_factory=dict)
    # PP-fused schedules (tasks stamped pp_stage/pp_microbatch):
    # per-(stage, microbatch) wall-clock span and per-phase busy breakdown.
    # Bubble absorption shows up as a cell's "stage"/"dispatch" phase time
    # overlapping the neighbouring cells' spans.
    stage_span_us: dict = dataclasses.field(default_factory=dict)
    stage_phase_us: dict = dataclasses.field(default_factory=dict)
    # Per-link-class transfer busy time: {"local"/"link"} flat, or
    # {"local"/"intra"/"inter"} when the cost model carries a Topology —
    # where the comm time actually lives in a hierarchical cluster.
    link_us: dict = dataclasses.field(default_factory=dict)

    @property
    def l2_hit_rate(self) -> float:
        return self.l2_hits / max(1, self.l2_lookups)


def _phase_of(td: TaskDescriptor) -> str:
    """Phase kind for the per-phase breakdown (comm kinds from TD meta)."""
    if td.task_type == "put_mem_signal":
        return td.meta.get("comm_kind", "dispatch")
    if td.task_type == "LayerBoundary":
        return "boundary"
    if td.task_type == "StageBoundary":
        return "stage"
    return "gmm" if td.queue_type == CTQ else "vector"


class _L2:
    """Per-rank LRU of recently-touched tile ranges (byte-weighted)."""

    def __init__(self, capacity: int):
        self.cap = capacity
        self.entries: OrderedDict[tuple, int] = OrderedDict()
        self.used = 0

    def touch(self, key: tuple, nbytes: int) -> None:
        if key in self.entries:
            self.used -= self.entries.pop(key)
        self.entries[key] = nbytes
        self.used += nbytes
        while self.used > self.cap and self.entries:
            _, b = self.entries.popitem(last=False)
            self.used -= b

    def hit(self, key: tuple) -> bool:
        if key in self.entries:
            self.entries.move_to_end(key)
            return True
        return False


def _task_duration_us(td: TaskDescriptor, cost: CostModel, l2: _L2,
                      count_l2) -> float:
    """Execution time of one tile task on its unit (excl. queue overhead).

    The timing formula itself lives in :class:`CostModel` (shared with the
    compile-time passes); this wrapper only owns the simulator's L2 *state*
    — which input tiles hit, what the miss allocates — and hands the
    resulting hit fraction to the model.
    """
    if td.task_type in ("put_mem_signal", "StageBoundary"):
        # Link-bound tasks: no L2 term — a StageBoundary tile streams the
        # activation payload over the stage link, not from HBM.
        return cost.task_us(td)
    total_rows = sum(r.hi - r.lo for r in td.inputs) or 1
    hit_b = miss_b = 0.0
    for rng in td.inputs:
        key = (rng.tensor, rng.rank, rng.lo, rng.hi)
        rows = rng.hi - rng.lo
        if l2.hit(key):
            hit_b += rows
            count_l2(True)
        else:
            miss_b += rows
            count_l2(False)
            # read-miss allocates in L2 (streams evict older residents).
            l2.touch(key, int(td.read_bytes * rows / total_rows))
    frac = hit_b / max(1.0, hit_b + miss_b)
    return cost.task_us(td, frac)


def _touch_outputs(td: TaskDescriptor, l2s: dict[int, _L2]) -> None:
    for rng in td.outputs:
        l2s[rng.rank].touch((rng.tensor, rng.rank, rng.lo, rng.hi),
                            int(td.write_bytes / max(1, len(td.outputs))))


def simulate_unified(s: Schedule, hw: AscendA3 = AscendA3(), *,
                     dispatch_overhead_us: float | None = None,
                     serialize_dispatch: bool = False,
                     workers_per_pool: dict | None = None,
                     cost: CostModel | None = None,
                     fragment_barrier: bool = False,
                     stage_barrier: bool = False) -> SimResult:
    """Event-driven simulation of the single-launch unified runtime.

    ``serialize_dispatch`` models an *online dynamic* scheduler: task
    dispatch decisions go through one device-side scheduler, so per-task
    overheads serialize on the critical path (§6.2). The static path's
    dispatch is per-worker queue consumption and overlaps freely.
    ``cost`` overrides the per-task duration model (default: the shared
    ``CostModel`` on ``hw`` with L2 residency effects on).
    ``fragment_barrier`` serializes multi-fragment taskflows: fragment
    ``j`` may not start until every task of fragments ``< j`` has
    finished. This is the back-to-back per-layer reference a fused
    schedule is measured against — identical tasks and costs, with the
    cross-fragment overlap switched off.
    ``stage_barrier`` is the pipeline-parallel analogue: cell (s, m) of a
    PP-fused schedule may not start until its feeding cell (same
    microbatch, previous stage in this direction's dataflow) and its
    stage predecessor (same stage, previous microbatch) have fully
    drained. That is a synchronous pipeline — still pipelined across
    stages, but with no intra-cell work absorbed into neighbours' bubbles
    — the fair reference PP fusion is measured against. On schedules
    without pp_stage metadata it degrades to ``fragment_barrier``.
    """
    if fragment_barrier and stage_barrier:
        raise ValueError("fragment_barrier and stage_barrier are "
                         "mutually exclusive references")
    cost = cost or CostModel(hw=hw)
    oh = (hw.static_dispatch_us if dispatch_overhead_us is None
          else dispatch_overhead_us)
    pools = workers_per_pool or {CTQ: hw.num_aic, VTQ: hw.num_aiv}
    sched_clock: dict[int, float] = defaultdict(float)  # per-rank clock

    ranks = sorted({r for (r, _) in s.queues})
    l2s = {r: _L2(hw.l2_bytes) for r in ranks}
    l2_stats = [0, 0]

    def count_l2(hit: bool):
        l2_stats[0] += int(hit)
        l2_stats[1] += 1

    cursors = {k: 0 for k in s.queues}
    idle = {k: pools[k[1]] for k in s.queues}
    counters: dict[int, int] = defaultdict(int)
    waiters: dict[int, list[int]] = defaultdict(list)   # eid -> [tid]
    # Link clocks are per (rank, link class): with a Topology the intra-node
    # bus and the inter-node NIC are independent resources, so intra traffic
    # never queues behind an inter-node transfer (and vice versa).
    egress_free: dict = defaultdict(float)
    ingress_free: dict = defaultdict(float)
    link_busy: dict = defaultdict(float)
    busy: dict = defaultdict(float)
    timeline: list = []
    heap: list = []       # (time, seq, kind, payload)
    seq = 0
    done = 0
    now = 0.0
    comm_busy_intervals: list[tuple[float, float]] = []
    cube_busy_intervals: list[tuple[float, float]] = []
    phase_busy: dict = defaultdict(float)
    frag_span: dict = {}
    stage_span: dict = {}
    stage_phase: dict = defaultdict(lambda: defaultdict(float))
    d2c = [None, None]        # [first dispatch begin, last combine end]

    def frag_of(td):
        return td.meta.get("fragment", 0)

    frag_total: dict[int, int] = defaultdict(int)
    frag_done: dict[int, int] = defaultdict(int)
    barrier_waiters: dict[int, list[int]] = defaultdict(list)
    if fragment_barrier or stage_barrier:
        for td in s.tasks:
            frag_total[frag_of(td)] += 1
    open_frag = min(frag_total, default=0)
    # stage_barrier prerequisite graph: fragment -> fragments that must
    # fully drain first (feeding cell + same-stage predecessor microbatch).
    frag_prereq: dict[int, tuple[int, ...]] = {}
    stage_waiters: dict[int, list[int]] = defaultdict(list)
    if stage_barrier:
        frag_cell: dict[int, tuple[int, int]] = {}
        for td in s.tasks:
            f = frag_of(td)
            if f not in frag_cell and "pp_stage" in td.meta:
                frag_cell[f] = (td.meta["pp_stage"],
                                td.meta.get("pp_microbatch", 0))
        if frag_cell:
            cell_frag = {c: f for f, c in frag_cell.items()}
            step = 1 if s.direction == "forward" else -1
            for f, (st_, m) in frag_cell.items():
                frag_prereq[f] = tuple(
                    cell_frag[c] for c in ((st_, m - 1), (st_ - step, m))
                    if c in cell_frag)
        else:
            frag_prereq = {f: ((f - 1,) if f - 1 in frag_total else ())
                           for f in frag_total}

    def cell_ready(f):
        return all(frag_done[p] >= frag_total[p]
                   for p in frag_prereq.get(f, ()))

    def push(t, kind, payload):
        nonlocal seq
        heapq.heappush(heap, (t, seq, kind, payload))
        seq += 1

    def dispatch_at(t, rank):
        """Time the dispatch decision lands (serialized for dynamic)."""
        if serialize_dispatch:
            begin = max(t, sched_clock[rank])
            sched_clock[rank] = begin + oh
            return begin + oh
        return t + oh

    def admit(tid, t):
        """Event gate for a fetched TD (past any fragment barrier)."""
        td = s.tasks[tid]
        if (td.dependent_event == NO_EVENT
                or counters[td.dependent_event]
                >= td.dependent_threshold):
            push(dispatch_at(t, td.rank), "start", tid)
        else:
            waiters[td.dependent_event].append(tid)

    def try_fetch(key, t):
        """Idle workers grab next TDs in order (§4.4 queue protocol)."""
        q = s.queues[key]
        while idle[key] > 0 and cursors[key] < len(q):
            tid = q[cursors[key]]
            cursors[key] += 1
            idle[key] -= 1
            td = s.tasks[tid]
            if fragment_barrier and frag_of(td) > open_frag:
                barrier_waiters[frag_of(td)].append(tid)
            elif stage_barrier and not cell_ready(frag_of(td)):
                stage_waiters[frag_of(td)].append(tid)
            else:
                admit(tid, t)

    def start_task(tid, t):
        td = s.tasks[tid]
        dur = _task_duration_us(td, cost, l2s[td.rank], count_l2)
        begin = t
        if (td.task_type == "put_mem_signal" and td.dst_rank >= 0
                and td.dst_rank != td.src_rank):
            # Work-conserving fluid link model: the transfer queues ``dur``
            # of work on the source egress and destination ingress clocks
            # independently and completes when both have drained it. This
            # avoids artificial convoy holes from joint interval booking
            # while still capturing per-link serialization (the RATR
            # hotspot effect shows up as an inflated ingress clock).
            cls = cost.link_class_of(td)
            e0 = max(egress_free[(td.src_rank, cls)], t) + dur
            i0 = max(ingress_free[(td.dst_rank, cls)], t) + dur
            egress_free[(td.src_rank, cls)] = e0
            ingress_free[(td.dst_rank, cls)] = i0
            begin = max(e0, i0) - dur
            comm_busy_intervals.append((begin, begin + dur))
            link_busy[cls] += dur
        elif td.task_type == "put_mem_signal":
            link_busy[cost.link_class_of(td)] += dur
        elif td.task_type == "StageBoundary":
            # The activation handoff rides the stage link's egress from
            # this rank, sharing the wire with EP cross-node traffic of the
            # same class — PP fusion only wins when the bubble has room for
            # both.
            cls = cost.link_class_of(td)
            e0 = max(egress_free[(td.rank, cls)], t) + dur
            egress_free[(td.rank, cls)] = e0
            begin = e0 - dur
            comm_busy_intervals.append((begin, begin + dur))
            link_busy[cls] += dur
        end = begin + dur
        key = (td.rank, td.queue_type)
        busy[key] += dur
        if td.queue_type == CTQ:
            cube_busy_intervals.append((begin, end))
        ph = _phase_of(td)
        phase_busy[ph] += dur
        if ph == "dispatch":
            d2c[0] = begin if d2c[0] is None else min(d2c[0], begin)
        elif ph == "combine":
            d2c[1] = end if d2c[1] is None else max(d2c[1], end)
        fr = td.meta.get("fragment")
        if fr is not None:
            lo, hi = frag_span.get(fr, (begin, end))
            frag_span[fr] = (min(lo, begin), max(hi, end))
        ps = td.meta.get("pp_stage")
        if ps is not None:
            cell = (ps, td.meta.get("pp_microbatch", 0))
            lo, hi = stage_span.get(cell, (begin, end))
            stage_span[cell] = (min(lo, begin), max(hi, end))
            stage_phase[cell][ph] += dur
        timeline.append((begin, end, td.rank, td.queue_type, td.op_name))
        push(end, "finish", tid)

    for key in s.queues:
        try_fetch(key, 0.0)

    while heap:
        now, _, kind, tid = heapq.heappop(heap)
        td = s.tasks[tid]
        if kind == "start":
            start_task(tid, now)
        else:  # finish
            _touch_outputs(td, l2s)
            done += 1
            key = (td.rank, td.queue_type)
            idle[key] += 1
            if fragment_barrier:
                f = frag_of(td)
                frag_done[f] += 1
                while (open_frag in frag_total
                       and frag_done[open_frag] >= frag_total[open_frag]):
                    open_frag += 1
                    for w in barrier_waiters.pop(open_frag, []):
                        admit(w, now)
            elif stage_barrier:
                f = frag_of(td)
                frag_done[f] += 1
                if frag_done[f] >= frag_total[f]:
                    for wf in [w for w in stage_waiters if cell_ready(w)]:
                        for w in stage_waiters.pop(wf):
                            admit(w, now)
            if td.trigger_event != NO_EVENT:
                eid = td.trigger_event
                counters[eid] += 1
                thr = s.events[eid].threshold
                if counters[eid] >= thr and waiters[eid]:
                    for w in waiters.pop(eid):
                        push(dispatch_at(now, s.tasks[w].rank), "start", w)
            try_fetch(key, now)

    if done != s.n_tasks:
        raise ScheduleError(f"simulator deadlock: {done}/{s.n_tasks}")

    makespan = max((e for (_, e, *_ ) in timeline), default=0.0)
    n_cube_pools = len([k for k in s.queues if k[1] == CTQ])
    cube_busy = sum(v for k, v in busy.items() if k[1] == CTQ)
    mac_ratio = (cube_busy / (makespan * max(1, n_cube_pools) * hw.num_aic)
                 if makespan else 0.0)
    exposed = _exposed_time(comm_busy_intervals, cube_busy_intervals)
    # Straggler is over the whole EP group: a rank with zero tasks (fully
    # starved by the plan) must drag the mean down, not vanish from it.
    straggler, crit = _straggler(busy, range(s.ep))
    d2c_us = (d2c[1] - d2c[0]
              if d2c[0] is not None and d2c[1] is not None else makespan)
    return SimResult(makespan_us=makespan, busy_us=dict(busy),
                     mac_ratio=mac_ratio, exposed_comm_us=exposed,
                     l2_hits=l2_stats[0], l2_lookups=l2_stats[1],
                     timeline=timeline, straggler_ratio=straggler,
                     critical_rank=crit, phase_us=dict(phase_busy),
                     dispatch_to_combine_us=d2c_us,
                     fragment_makespan_us={f: hi - lo for f, (lo, hi)
                                           in sorted(frag_span.items())},
                     stage_span_us={c: hi - lo for c, (lo, hi)
                                    in sorted(stage_span.items())},
                     stage_phase_us={c: dict(v) for c, v
                                     in sorted(stage_phase.items())},
                     link_us=dict(link_busy))


def _straggler(busy: dict, ranks) -> tuple[float, int]:
    """(max/mean per-rank cube busy, most-loaded rank) over the EP group."""
    per_rank = {r: busy.get((r, CTQ), 0.0) for r in ranks}
    if not per_rank:
        return 1.0, -1
    mean = sum(per_rank.values()) / len(per_rank)
    crit = max(per_rank, key=per_rank.get)
    return (per_rank[crit] / mean if mean > 0 else 1.0), crit


def _merge(intervals):
    out = []
    for s0, e0 in sorted(intervals):
        if out and s0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e0)
        else:
            out.append([s0, e0])
    return out


def _exposed_time(comm, cube) -> float:
    """Comm-in-flight time not covered by any cube activity."""
    comm_m, cube_m = _merge(comm), _merge(cube)
    exposed = 0.0
    j = 0
    for cs, ce in comm_m:
        t = cs
        while t < ce:
            while j < len(cube_m) and cube_m[j][1] <= t:
                j += 1
            if j >= len(cube_m) or cube_m[j][0] >= ce:
                exposed += ce - t
                break
            if cube_m[j][0] > t:
                exposed += cube_m[j][0] - t
            t = cube_m[j][1]
    return exposed


def simulate_baseline(s: Schedule, hw: AscendA3 = AscendA3(), *,
                      cost: CostModel | None = None) -> SimResult:
    """Operator-by-operator execution with collective comm (§2.3 profile).

    Ops run as full-device kernels in topological order; AllToAll is a
    host-synchronized collective across the whole EP group; AIC and AIV
    alternate (a kernel owns the device). GMM tiles use the *same* per-tile
    efficiency (the shared ``CostModel``) as the unified mode.
    """
    cost = cost or CostModel(hw=hw)
    # Group tasks by operator in schedule (≙ topological) order.
    op_order: list[str] = []
    op_tasks: dict[str, list[TaskDescriptor]] = defaultdict(list)
    for td in s.tasks:
        if td.op_name not in op_tasks:
            op_order.append(td.op_name)
        op_tasks[td.op_name].append(td)

    # Collapse per-rank op instances into phases by op kind (Dispatch@0..N
    # form one collective phase; GMM1@0..N one kernel phase, etc.).
    phase_order: list[str] = []
    phases: dict[str, list[TaskDescriptor]] = defaultdict(list)
    for name in op_order:
        kind = name.split("@")[0]
        if kind not in phases:
            phase_order.append(kind)
        phases[kind].extend(op_tasks[name])

    ranks = sorted({r for (r, _) in s.queues})
    l2s = {r: _L2(hw.l2_bytes) for r in ranks}
    l2_stats = [0, 0]

    def count_l2(hit):
        l2_stats[0] += int(hit)
        l2_stats[1] += 1

    now = 0.0
    busy: dict = defaultdict(float)
    timeline = []
    comm_iv, cube_iv = [], []
    phase_busy: dict = defaultdict(float)
    d2c = [None, None]
    for kind in phase_order:
        tds = phases[kind]
        ph = _phase_of(tds[0])
        is_comm = tds[0].task_type == "put_mem_signal"
        if is_comm:
            # Host-synchronized collective AllToAllV. Unlike one-sided
            # put_mem_signal (which scatters directly into the remote
            # layout), A2AV needs contiguous send buffers: an AIV pack pass
            # before the collective and an unpack pass after it, both on the
            # critical path. Link time is bounded by the busiest rank.
            per_rank_bytes = defaultdict(float)
            total_rank_bytes = defaultdict(float)
            for td in tds:
                total_rank_bytes[td.src_rank] += td.comm_bytes
                if td.dst_rank != td.src_rank:
                    per_rank_bytes[td.src_rank] += td.comm_bytes
            link_t = (max(per_rank_bytes.values(), default=0.0)
                      / (hw.link_gbps * 1e3))
            pack_bytes = max(total_rank_bytes.values(), default=0.0)
            # pack on source + unpack on destination: streaming copies that
            # ride the L2 (read bw ≈ l2_read_x_hbm × HBM), one pass each.
            l2_bw = hw.l2_read_x_hbm * hw.hbm_gbps * 1e3
            pack_t = 2 * (2 * pack_bytes) / l2_bw
            dur = pack_t + link_t + hw.collective_host_us
            timeline.append((now, now + dur, -1, "COLL", kind))
            comm_iv.append((now + pack_t / 2, now + pack_t / 2 + link_t))
            phase_busy[ph] += dur
            if ph == "dispatch":
                d2c[0] = now if d2c[0] is None else min(d2c[0], now)
            elif ph == "combine":
                d2c[1] = (now + dur if d2c[1] is None
                          else max(d2c[1], now + dur))
            now += dur + hw.kernel_launch_us
            continue
        # Full-device kernel phase. Production operators balance their own
        # internal tiling across the pool, so the phase is work-conserving:
        # duration = total unit-time / pool width (not our tile packing).
        pool_n = hw.num_aic if tds[0].queue_type == CTQ else hw.num_aiv
        phase_end = now
        for r in ranks:
            mine = [td for td in tds if td.rank == r]
            work = 0.0
            for td in mine:
                dur = _task_duration_us(td, cost, l2s[r], count_l2)
                work += dur
                busy[(r, td.queue_type)] += dur
                _touch_outputs(td, l2s)
            rank_end = now + work / pool_n
            if mine and mine[0].queue_type == CTQ:
                cube_iv.append((now, rank_end))
            phase_end = max(phase_end, rank_end)
        timeline.append((now, phase_end, -1, tds[0].queue_type, kind))
        phase_busy[ph] += phase_end - now
        now = phase_end + hw.kernel_launch_us

    makespan = now - hw.kernel_launch_us
    cube_busy = sum(v for k, v in busy.items() if k[1] == CTQ)
    mac_ratio = cube_busy / (makespan * len(ranks) * hw.num_aic)
    straggler, crit = _straggler(busy, range(s.ep))
    d2c_us = (d2c[1] - d2c[0]
              if d2c[0] is not None and d2c[1] is not None else makespan)
    return SimResult(makespan_us=makespan, busy_us=dict(busy),
                     mac_ratio=mac_ratio,
                     exposed_comm_us=_exposed_time(comm_iv, cube_iv),
                     l2_hits=l2_stats[0], l2_lookups=l2_stats[1],
                     timeline=timeline, straggler_ratio=straggler,
                     critical_rank=crit, phase_us=dict(phase_busy),
                     dispatch_to_combine_us=d2c_us)
