"""Static scheduling + event-driven synchronization (§4.3).

Compiles the TD collection generated from an ODG into per-rank CTQ/VTQ
taskflows augmented with threshold event counters:

1. *Dependency derivation* — a consumer depends on every producer whose write
   range overlaps one of its read ranges (true tile-level data readiness,
   not operator barriers).
2. *Event allocation* — consumers sharing an identical producer set share one
   event (paper: "multiple downstream tasks may wait on the same event");
   the event threshold equals the producer count (paper: "multiple upstream
   tasks may contribute to the same event counter"). Each producer triggers
   exactly one event — the single ``trigger_event`` field of Table 1. Split
   propagation guarantees aligned boundaries, which is what makes the
   single-trigger invariant hold; the scheduler *verifies* it and raises on
   violation instead of silently emitting an illegal plan.
3. *Queue construction* — per (rank, CTQ/VTQ) task order; workers consume
   in order and wait on dependent events, so the combined (queue ∪ event)
   order must be deadlock-free.
4. *Pass pipeline* — an ordered, serializable list of registered schedule
   passes (``core/passes.py``: RATR, cache-guided GMM interleaving, chain
   interleaving, critical-rank-first, …) permutes mutually independent
   queue entries; ``Schedule.opts`` records the pipeline spec, and
   ``validate_schedule`` then proves the final (queue ∪ event) combination
   deadlock-free by symbolic execution of the counters.

All stages are extent-agnostic: dependency derivation works on the exact
(possibly ragged) tile ranges the plan-driven FillConfigs emit, so
imbalanced RoutingPlans — variable cell sizes, empty cells, whole ranks
with zero tasks — compile through the same path as the balanced grid.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Optional

from .odg import ODG, CTQ, VTQ
from .split import propagate_splits
from .tasks import NO_EVENT, Range, TaskDescriptor, fill_tasks


@dataclasses.dataclass
class Event:
    eid: int
    threshold: int
    home_rank: int
    producers: tuple[int, ...]   # tids that trigger this event


@dataclasses.dataclass
class Schedule:
    """The full compiled taskflow for one EP group (all ranks)."""

    direction: str
    ep: int
    tasks: list[TaskDescriptor]                    # indexed by tid
    events: dict[int, Event]
    queues: dict[tuple[int, str], list[int]]       # (rank, CTQ|VTQ) -> [tid]
    opts: dict = dataclasses.field(default_factory=dict)

    def queue(self, rank: int, qtype: str) -> list[int]:
        return self.queues.get((rank, qtype), [])

    @property
    def n_tasks(self) -> int:
        return len(self.tasks)


class ScheduleError(RuntimeError):
    pass


def _derive_dependencies(tasks: list[TaskDescriptor]) -> list[set[int]]:
    """Producer tid set per task, from tile-range overlap."""
    writers: dict[tuple[str, int], list[tuple[Range, int]]] = defaultdict(list)
    for td in tasks:
        for w in td.outputs:
            writers[(w.tensor, w.rank)].append((w, td.tid))
    deps: list[set[int]] = []
    for td in tasks:
        producers: set[int] = set()
        for rd in td.inputs:
            for (w, tid) in writers.get((rd.tensor, rd.rank), ()):  # noqa: B905
                if tid != td.tid and w.overlaps(rd):
                    producers.add(tid)
        deps.append(producers)
    return deps


def _allocate_events(tasks: list[TaskDescriptor], deps: list[set[int]],
                     allow_multi_trigger: bool = False) -> dict[int, Event]:
    """Dedup producer sets into shared threshold events (§4.3)."""
    events: dict[int, Event] = {}
    group_to_eid: dict[frozenset, int] = {}
    producer_trigger: dict[int, int] = {}

    for td, producers in zip(tasks, deps):
        if not producers:
            td.dependent_event = NO_EVENT
            td.dependent_threshold = 0
            continue
        key = frozenset(producers)
        eid = group_to_eid.get(key)
        if eid is None:
            eid = len(events)
            events[eid] = Event(eid=eid, threshold=len(producers),
                                home_rank=td.rank,
                                producers=tuple(sorted(producers)))
            group_to_eid[key] = eid
            for p in producers:
                if p in producer_trigger and producer_trigger[p] != eid:
                    if not allow_multi_trigger:
                        raise ScheduleError(
                            f"single-trigger invariant violated: task "
                            f"{tasks[p].op_name}#{tasks[p].task_index} would "
                            f"trigger events {producer_trigger[p]} and {eid}. "
                            f"Tile boundaries are misaligned — split "
                            f"propagation should have prevented this.")
                producer_trigger[p] = eid
        else:
            # All consumers of this event must live where the counter lives.
            if events[eid].home_rank != td.rank:
                raise ScheduleError(
                    f"event {eid} consumers span ranks "
                    f"{events[eid].home_rank} and {td.rank}")
        td.dependent_event = eid
        td.dependent_threshold = events[eid].threshold

    for p, eid in producer_trigger.items():
        tasks[p].trigger_event = eid
    return events


def compile_schedule(g: ODG, *, pipeline=None, ratr: bool = False,
                     gmm_interleave: bool = False,
                     chain_interleave: bool = False,
                     allow_multi_trigger: bool = False) -> Schedule:
    """ODG → validated per-rank CTQ/VTQ taskflow (the SSC payload).

    ``pipeline`` names the ordered schedule passes to run between queue
    construction and validation — a :class:`~repro_torch.core.passes.Pipeline`, a
    list of pass names, or a serialized spec. The legacy boolean kwargs
    (``ratr=`` / ``gmm_interleave=`` / ``chain_interleave=``) are shimmed
    onto the equivalent canonical pipeline and compile byte-identical SSC
    blobs; they are mutually exclusive with ``pipeline``.

    ``pipeline="auto"`` resolves through the cost-model-guided selector
    (``core/autoselect.py``) against this graph's config and direction; the
    *resolved* spec — never the literal ``"auto"`` — is what lands in
    ``Schedule.opts`` (and hence the SSC blob). The tiling is pinned here
    because the ODG's task set is already built; callers who want the
    selector's ``gmm_m_split`` budget grid resolve before building the
    graph (``SSCCache.get_or_compile`` does).
    """
    from .passes import resolve_pipeline
    from .autoselect import auto_pipeline, is_auto
    if is_auto(pipeline):
        pipe, _ = auto_pipeline(None, g.cfg, direction=g.direction,
                                allow_retile=False)
    else:
        pipe = resolve_pipeline(pipeline, ratr=ratr,
                                gmm_interleave=gmm_interleave,
                                chain_interleave=chain_interleave)

    propagate_splits(g)

    tasks: list[TaskDescriptor] = []
    for op in g.topological():
        tds = fill_tasks(g, op)
        for td in tds:
            td.tid = len(tasks)
            tasks.append(td)

    deps = _derive_dependencies(tasks)
    events = _allocate_events(tasks, deps,
                              allow_multi_trigger=allow_multi_trigger)

    queues: dict[tuple[int, str], list[int]] = defaultdict(list)
    for td in tasks:
        queues[(td.rank, td.queue_type)].append(td.tid)

    sched = Schedule(direction=g.direction, ep=g.cfg.ep, tasks=tasks,
                     events=events, queues=dict(queues),
                     opts={"pipeline": pipe.spec()})

    pipe.run(sched, g.cfg)

    validate_schedule(sched)
    return sched


# ---------------------------------------------------------------------------
# Deadlock-freedom / legality validation by symbolic counter execution.
# ---------------------------------------------------------------------------

def validate_schedule(s: Schedule) -> None:
    """Prove the (queue order ∪ event) combination admits full execution.

    Workers consume queues in order and block on dependent events, so a legal
    schedule must let some queue head run at every step until all tasks
    complete. This is exactly the runtime protocol of §4.4, executed
    symbolically.
    """
    cursors = {k: 0 for k in s.queues}
    counters: dict[int, int] = defaultdict(int)
    done = 0
    total = s.n_tasks
    # Tasks must each sit in exactly one queue.
    enqueued = sum(len(q) for q in s.queues.values())
    if enqueued != total:
        raise ScheduleError(f"{total} tasks but {enqueued} queue entries")

    progressed = True
    while done < total:
        if not progressed:
            stuck = {k: (s.tasks[s.queues[k][c]].op_name
                         if c < len(s.queues[k]) else "<drained>")
                     for k, c in cursors.items()}
            raise ScheduleError(f"deadlock: no queue head is ready; "
                                f"completed {done}/{total}; heads={stuck}")
        progressed = False
        for key, q in s.queues.items():
            while cursors[key] < len(q):
                td = s.tasks[q[cursors[key]]]
                if (td.dependent_event != NO_EVENT
                        and counters[td.dependent_event]
                        < td.dependent_threshold):
                    break
                # run it
                if td.trigger_event != NO_EVENT:
                    counters[td.trigger_event] += 1
                cursors[key] += 1
                done += 1
                progressed = True


def execution_order(s: Schedule) -> list[int]:
    """One legal global completion order (round-robin over queue heads)."""
    cursors = {k: 0 for k in s.queues}
    counters: dict[int, int] = defaultdict(int)
    order: list[int] = []
    keys = sorted(s.queues.keys())
    while len(order) < s.n_tasks:
        progressed = False
        for key in keys:
            q = s.queues[key]
            if cursors[key] >= len(q):
                continue
            td = s.tasks[q[cursors[key]]]
            if (td.dependent_event != NO_EVENT
                    and counters[td.dependent_event] < td.dependent_threshold):
                continue
            if td.trigger_event != NO_EVENT:
                counters[td.trigger_event] += 1
            cursors[key] += 1
            order.append(td.tid)
            progressed = True
        if not progressed:
            raise ScheduleError("deadlock during execution_order")
    return order
