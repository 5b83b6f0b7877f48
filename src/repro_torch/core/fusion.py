"""Cross-layer schedule fusion — multi-fragment taskflows; a copy of
``repro.core.fusion`` (its schedules and ``SimResult``s equal the
reference's exactly). The state loaders at the end put every tensor on the
``ExecutorState``'s device.

A compiled :class:`~repro_torch.core.scheduler.Schedule` covers one MoE-FFN
fragment (one layer, one direction). Executing layers back-to-back turns
every layer boundary into a hard barrier: combine fully drains before the
next dispatch starts — exactly the serialization the paper attacks *inside*
a layer. This module stitches K per-layer schedules into one statically
scheduled :class:`FusedSchedule` whose cross-fragment dependency edges
follow actual tile dataflow, so layer N+1's dispatch communication issues
per-rank as soon as that rank's boundary remap is ready, overlapping layer
N's combine and GMM tails on the other ranks.

Mechanics:

* Every fragment's tasks are cloned with tensors renamed ``{t}#L{i}`` and
  op names prefixed ``L{i}/`` (``i`` is the *layer* index, so backward
  fusion — which executes fragments in reversed layer order — keeps
  layer-faithful names). ``meta["fragment"]`` records the execution
  position, which is how passes, the cost model, and the simulator
  declare fragment scope.
* Between consecutive fragments, per-rank ``LayerBoundary`` VTQ tasks model
  the inter-layer token remap (layer-i combine-weighted sum composed with
  layer-i+1 routing). The remap is exactly rank-local — a token's combine
  rows and its next-layer send rows both live on its own source rank — so
  per-rank boundary tasks are an exact conservative dependency model, not
  an approximation. Tiles group *whole* downstream dispatch cells (never
  splitting a cell) so each tile triggers exactly one event and the
  scheduler's single-trigger invariant holds by construction.
* Dependencies and events are re-derived over the full task list with the
  same ``_derive_dependencies`` / ``_allocate_events`` machinery the
  per-fragment compiler uses; queue order concatenates each fragment's
  (already pass-optimized) queues with the boundary tiles in between, so a
  sequential fragment-by-fragment execution always exists and the fused
  schedule is deadlock-free by construction (and re-verified by
  ``validate_schedule``).

The numerical boundary remap itself is *not* part of the schedulable
fragment (it owns the top-k weighting, like Combine's accumulation); the
executor calls a per-(junction, rank) ``boundary_fn`` — see
``models/moe.py`` for the dropless implementation (on device tensors) and
``core/executor.py`` for the handler contract.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Optional, Sequence

from .odg import VTQ, ScheduleConfig, build_moe_ffn_backward, \
    build_moe_ffn_forward
from .scheduler import Schedule, ScheduleError, _allocate_events, \
    _derive_dependencies, compile_schedule, validate_schedule
from .tasks import NO_EVENT, Range, TaskDescriptor

# Max LayerBoundary tiles per (junction, rank). Tiling matters for cost
# fidelity: one monolithic boundary task per rank would serialize the whole
# junction on a single AIV unit in the simulator (~10x the real fused
# makespan); ~64 whole-cell groups price like the vector op it models while
# keeping the task count small.
DEFAULT_BOUNDARY_SPLIT = 64

# Tensor pair bridged at each junction, per direction: upstream fragment's
# terminal send-layout output -> downstream fragment's send-layout input.
_BRIDGE_BASES = {"forward": ("y_ret", "x_src"),
                 "backward": ("dx_ret", "dy_src")}


@dataclasses.dataclass(frozen=True)
class Fragment:
    """One per-layer schedule's slice of the fused task list."""

    index: int                  # execution position (0 runs first)
    label: str                  # layer label, e.g. "L0" — tensor/op suffix
    tid_lo: int                 # half-open tid range of the cloned tasks
    tid_hi: int
    # LayerBoundary tiles feeding this fragment (empty for fragment 0).
    boundary_tids: tuple[int, ...] = ()

    @property
    def n_tasks(self) -> int:
        return self.tid_hi - self.tid_lo


@dataclasses.dataclass
class FusedSchedule(Schedule):
    """A multi-fragment taskflow; ``tasks``/``events``/``queues`` span all
    fragments, ``fragments`` records the per-layer slices."""

    fragments: tuple = ()       # tuple[Fragment, ...] in execution order

    @property
    def n_fragments(self) -> int:
        return len(self.fragments)

    def fragment_tids(self, index: int) -> list[int]:
        f = self.fragments[index]
        return list(range(f.tid_lo, f.tid_hi))


def _rename(rng: Range, label: str) -> Range:
    return Range(f"{rng.tensor}#{label}", rng.rank, rng.lo, rng.hi)


def _clone_task(td: TaskDescriptor, label: str, frag: int,
                extra_meta: Optional[dict] = None) -> TaskDescriptor:
    """Fragment-scoped copy: renamed tensors/ops, event fields reset.

    ``_allocate_events`` only assigns ``trigger_event`` to tasks that end up
    producers, so stale event ids from the source schedule must be cleared
    here, not merely overwritten later. ``extra_meta`` tags every cloned
    task (the PP interleaver stamps ``pp_stage``/``pp_microbatch``).
    """
    return dataclasses.replace(
        td,
        inputs=[_rename(r, label) for r in td.inputs],
        outputs=[_rename(r, label) for r in td.outputs],
        op_name=f"{label}/{td.op_name}",
        meta={**td.meta, "fragment": frag, **(extra_meta or {})},
        dependent_event=NO_EVENT,
        trigger_event=NO_EVENT,
        dependent_threshold=0,
        tid=-1)


def _boundary_tasks(up_label: str, dn_label: str, frag: int,
                    src_base: str, dst_base: str,
                    up_cfg: ScheduleConfig, dn_cfg: ScheduleConfig,
                    boundary_split: int, *, kind: str = "layer",
                    junction: Optional[int] = None,
                    extra_meta: Optional[dict] = None
                    ) -> list[TaskDescriptor]:
    """Per-rank boundary tiles for one junction (Layer- or StageBoundary).

    Tiles cover whole cells of the *downstream* plan's send layout, grouped
    into at most ``boundary_split`` chunks per rank. Whole-cell grouping is
    what keeps event allocation legal: every downstream dispatch cell is
    covered by exactly one tile, so each tile triggers exactly one event
    (the dispatch tasks it feeds share it as their sole producer).

    ``kind="layer"`` emits the rank-local token-remap VTQ tile (priced as
    AIV vector work); ``kind="stage"`` emits the pipeline-parallel twin —
    the same tiling and dedup invariants, but the tile carries the
    *activation payload* across the stage link (``comm_bytes`` set, priced
    on the topology's inter-node link class by the cost model). ``junction``
    is the id the executor's ``boundary_fns`` are keyed by (defaults to the
    layer-fusion convention ``frag - 1``).
    """
    up_plan, dn_plan = up_cfg.routing, dn_cfg.routing
    in_row_b = up_cfg.d_model * up_cfg.dtype_bytes
    out_row_b = dn_cfg.d_model * dn_cfg.dtype_bytes
    if junction is None:
        junction = frag - 1
    task_type = "LayerBoundary" if kind == "layer" else "StageBoundary"
    op_kind = "Boundary" if kind == "layer" else "StageBoundary"
    comm_kind = "boundary" if kind == "layer" else "stage"
    tds: list[TaskDescriptor] = []
    for r in range(dn_cfg.ep):
        cells = dn_plan.send_cells(r)        # (dst, e, count), contiguous
        if not cells:
            continue                         # rank sends nothing next layer
        total = sum(c for (_, _, c) in cells)
        target = -(-total // max(1, boundary_split))
        in_rows = up_plan.send_rows(r)
        # The remap consumes the rank's *entire* upstream return buffer
        # (combine-weighted sums mix every returned copy of a token), so
        # each tile reads the full range; zero upstream rows still yield a
        # valid tile — the remap of an all-zero combine.
        reads = ([Range(f"{src_base}#{up_label}", r, 0, in_rows)]
                 if in_rows > 0 else [])
        groups: list[tuple[int, int]] = []
        lo = acc = 0
        hi = 0
        for (_, _, c) in cells:
            hi += c
            acc += c
            if acc >= target:
                groups.append((lo, hi))
                lo, acc = hi, 0
        if acc > 0:
            groups.append((lo, hi))
        for i, (g_lo, g_hi) in enumerate(groups):
            chunk = g_hi - g_lo
            tds.append(TaskDescriptor(
                task_type=task_type, queue_type=VTQ,
                inputs=list(reads),
                outputs=[Range(f"{dst_base}#{dn_label}", r, g_lo, g_hi)],
                task_index=i, task_split_num=len(groups),
                task_split_value=chunk,
                read_bytes=chunk * in_row_b,
                write_bytes=chunk * out_row_b,
                comm_bytes=(chunk * out_row_b if kind == "stage" else 0),
                src_rank=(r if kind == "stage" else -1),
                dst_rank=(r if kind == "stage" else -1),
                op_name=f"{dn_label}/{op_kind}@{r}",
                op_type=f"{kind}_boundary", rank=r,
                meta={"fragment": frag, "boundary": junction,
                      "comm_kind": comm_kind, **(extra_meta or {})}))
    return tds


def _split_multirank_writer(td: TaskDescriptor) -> list[TaskDescriptor]:
    """Re-tile one comm task whose outputs land on several ranks into one
    copy per output range.

    The combine fill's fallback path (``core/tasks.py``: split propagation
    pinned ``task_num`` to 1) emits a single task returning rows to every
    source rank for highly concentrated plans. Unfused that is legal — the
    return buffer is terminal — but a fused junction *consumes* it on each
    rank, and one producer cannot trigger per-rank events. The fallback's
    outputs are ordered to match its sequential input layout, so block-wise
    re-tiling is an exact (bit-identical) refinement of the copy.
    """
    if td.task_type != "put_mem_signal" or len(td.inputs) != 1:
        raise ScheduleError(
            f"cannot re-tile multi-rank bridge writer {td.op_name}"
            f"#{td.task_index} ({td.task_type}) for fusion")
    i0 = td.inputs[0]
    rows = i0.hi - i0.lo
    row_b = td.read_bytes // rows if rows else 0
    parts = []
    off = i0.lo
    for idx, o in enumerate(td.outputs):
        c = o.hi - o.lo
        parts.append(dataclasses.replace(
            td,
            inputs=[Range(i0.tensor, i0.rank, off, off + c)],
            outputs=[o],
            task_index=idx, task_split_num=len(td.outputs),
            task_split_value=c,
            comm_bytes=c * row_b, read_bytes=c * row_b,
            write_bytes=c * row_b, dst_rank=o.rank,
            meta={**td.meta, "bridge_split": True}))
        off += c
    return parts


def _fragment_view(s: Schedule, bridge_src: Optional[str]):
    """One input schedule's (tasks, queues) as fused — with every
    multi-rank writer of the bridge tensor re-tiled per rank. Queue lists
    hold fragment-local task positions; ``bridge_src=None`` (no downstream
    junction) passes the schedule through verbatim."""
    if bridge_src is None:
        return list(s.tasks), {q: list(t) for q, t in s.queues.items()}
    expansion: dict[int, list[int]] = {}
    tasks: list[TaskDescriptor] = []
    for td in s.tasks:
        if (len(td.outputs) > 1
                and len({o.rank for o in td.outputs}) > 1
                and any(o.tensor == bridge_src for o in td.outputs)):
            parts = _split_multirank_writer(td)
        else:
            parts = [td]
        expansion[td.tid] = list(range(len(tasks), len(tasks) + len(parts)))
        tasks.extend(parts)
    queues = {q: [p for t in tids for p in expansion[t]]
              for q, tids in s.queues.items()}
    return tasks, queues


def fuse_schedules(scheds: Sequence[Schedule],
                   cfgs: Sequence[ScheduleConfig], *,
                   labels: Optional[Sequence[str]] = None,
                   fused_pipeline=("fuse_boundary",),
                   boundary_split: int = DEFAULT_BOUNDARY_SPLIT
                   ) -> FusedSchedule:
    """Stitch per-layer schedules (in *execution* order) into one taskflow.

    ``scheds``/``cfgs``/``labels`` are aligned and ordered by execution:
    layer order for forward, reversed layer order for backward. Each input
    schedule's queue order — including any per-fragment pass effects — is
    preserved verbatim inside its fragment; ``fused_pipeline`` names the
    fragment-spanning passes run on the stitched schedule afterwards.
    """
    from .passes import resolve_pipeline

    if not scheds:
        raise ValueError("fuse_schedules needs at least one schedule")
    if len(scheds) != len(cfgs):
        raise ValueError(f"{len(scheds)} schedules but {len(cfgs)} configs")
    direction = scheds[0].direction
    ep = scheds[0].ep
    for s in scheds:
        if s.direction != direction:
            raise ScheduleError(
                f"cannot fuse mixed directions {direction!r}/{s.direction!r}")
        if s.ep != ep:
            raise ScheduleError(f"cannot fuse ep={ep} with ep={s.ep}")
    src_base, dst_base = _BRIDGE_BASES[direction]
    K = len(scheds)
    if labels is None:
        labels = ([f"L{j}" for j in range(K)] if direction == "forward"
                  else [f"L{K - 1 - j}" for j in range(K)])
    labels = list(labels)
    if len(set(labels)) != K:
        raise ValueError(f"fragment labels must be unique, got {labels}")

    tasks: list[TaskDescriptor] = []
    fragments: list[Fragment] = []
    bases: list[int] = []
    boundary_tids: list[tuple[int, ...]] = []
    views = [_fragment_view(s, src_base if j < K - 1 else None)
             for j, s in enumerate(scheds)]
    for j, (cfg, (ftasks, _)) in enumerate(zip(cfgs, views)):
        btids: list[int] = []
        if j > 0:
            for td in _boundary_tasks(labels[j - 1], labels[j], j,
                                      src_base, dst_base,
                                      cfgs[j - 1], cfg, boundary_split):
                td.tid = len(tasks)
                btids.append(td.tid)
                tasks.append(td)
        boundary_tids.append(tuple(btids))
        bases.append(len(tasks))
        for td in ftasks:                    # fragment-local position order
            c = _clone_task(td, labels[j], j)
            c.tid = len(tasks)
            tasks.append(c)
        fragments.append(Fragment(index=j, label=labels[j],
                                  tid_lo=bases[j], tid_hi=len(tasks),
                                  boundary_tids=tuple(btids)))

    deps = _derive_dependencies(tasks)
    events = _allocate_events(tasks, deps)

    queues: dict[tuple[int, str], list[int]] = defaultdict(list)
    for j, (_, fqueues) in enumerate(views):
        for tid in boundary_tids[j]:
            queues[(tasks[tid].rank, VTQ)].append(tid)
        for (rank, qt) in sorted(fqueues):
            queues[(rank, qt)].extend(bases[j] + t for t in fqueues[(rank, qt)])

    fused_pipe = resolve_pipeline(fused_pipeline)
    fs = FusedSchedule(
        direction=direction, ep=ep, tasks=tasks, events=events,
        queues=dict(queues),
        opts={"pipeline": fused_pipe.spec(),
              "fragment_pipelines": [list(s.opts.get("pipeline", []))
                                     for s in scheds],
              "fragment_labels": labels,
              "boundary_split": boundary_split},
        fragments=tuple(fragments))

    fused_pipe.run(fs, cfgs[0])
    validate_schedule(fs)
    return fs


def compile_fused(cfgs: Sequence[ScheduleConfig], direction: str, *,
                  pipeline=None, pipelines=None,
                  fused_pipeline=("fuse_boundary",),
                  boundary_split: int = DEFAULT_BOUNDARY_SPLIT
                  ) -> FusedSchedule:
    """Compile K per-layer configs (in *layer* order) into a FusedSchedule.

    Backward fusion executes fragments in reversed layer order (layer K-1's
    upstream gradient arrives first) while labels stay layer-faithful, so
    ``dW1#L0`` in a fused backward schedule is layer 0's gradient no matter
    where its fragment sits in the taskflow.

    ``pipelines`` gives one per-layer pass pipeline each (layer order);
    ``pipeline`` applies one to every layer. ``pipeline="auto"`` resolves
    per layer against that layer's plan, exactly like the unfused path.
    """
    if direction not in _BRIDGE_BASES:
        raise ValueError(f"direction must be forward|backward, "
                         f"got {direction!r}")
    K = len(cfgs)
    if K == 0:
        raise ValueError("compile_fused needs at least one config")
    if pipelines is None:
        pipelines = [pipeline] * K
    if len(pipelines) != K:
        raise ValueError(f"{K} configs but {len(pipelines)} pipelines")
    builder = (build_moe_ffn_forward if direction == "forward"
               else build_moe_ffn_backward)
    scheds = [compile_schedule(builder(cfg), pipeline=p)
              for cfg, p in zip(cfgs, pipelines)]
    order = list(range(K)) if direction == "forward" else list(range(K))[::-1]
    return fuse_schedules([scheds[i] for i in order],
                          [cfgs[i] for i in order],
                          labels=[f"L{i}" for i in order],
                          fused_pipeline=fused_pipeline,
                          boundary_split=boundary_split)


# ---------------------------------------------------------------------------
# Pipeline-parallel fusion — stages × microbatches as fragments.
# ---------------------------------------------------------------------------

def pp_cell_order(n_stages: int, n_microbatches: int,
                  direction: str) -> list[tuple[int, int]]:
    """Wave-ordered (stage, microbatch) cells — the 1F1B interleave
    restricted to one direction.

    Cell (s, m) sits in wave ``depth(s) + m`` where ``depth`` is the
    stage's pipeline depth in this direction (``s`` forward, ``S-1-s``
    backward); within a wave, shallower stages come first. Microbatches
    within a stage therefore always execute in order, and adjacent cells
    of one wave are exactly the pairs 1F1B runs concurrently — stage s's
    EP dispatch/combine of microbatch m lands in the queue gaps where
    stage s would otherwise idle on m±1.
    """
    cells = []
    for s in range(n_stages):
        depth = s if direction == "forward" else n_stages - 1 - s
        for m in range(n_microbatches):
            cells.append((depth + m, depth, s, m))
    cells.sort()
    return [(s, m) for (_, _, s, m) in cells]


def fuse_pp_schedules(scheds: Sequence[Schedule],
                      cfgs: Sequence[ScheduleConfig],
                      n_microbatches: int, *,
                      fused_pipeline=("pp_interleave",),
                      boundary_split: int = DEFAULT_BOUNDARY_SPLIT
                      ) -> FusedSchedule:
    """Stitch per-*stage* schedules into one PP-fused taskflow.

    ``scheds``/``cfgs`` are per pipeline stage, in stage order; each stage
    is replicated once per microbatch, yielding ``S × M`` fragments in
    :func:`pp_cell_order`. Consecutive stages of the *same* microbatch are
    bridged with ``StageBoundary`` tiles that carry the activation payload
    over the stage link (physical junction ``m*(S-1) + min(s_up, s_dn)``,
    identical for forward and backward so one ``boundary_fns`` convention
    serves both). Every task is stamped ``pp_stage``/``pp_microbatch``,
    which is what the simulator's ``stage_barrier`` reference, per-cell
    phase accounting, and the ``pp_interleave`` pass key on.
    """
    from .passes import resolve_pipeline

    if not scheds:
        raise ValueError("fuse_pp_schedules needs at least one stage")
    if len(scheds) != len(cfgs):
        raise ValueError(f"{len(scheds)} schedules but {len(cfgs)} configs")
    if n_microbatches < 1:
        raise ValueError(f"n_microbatches must be >= 1, "
                         f"got {n_microbatches}")
    direction = scheds[0].direction
    ep = scheds[0].ep
    for s in scheds:
        if s.direction != direction:
            raise ScheduleError(
                f"cannot fuse mixed directions {direction!r}/{s.direction!r}")
        if s.ep != ep:
            raise ScheduleError(f"cannot fuse ep={ep} with ep={s.ep}")
    src_base, dst_base = _BRIDGE_BASES[direction]
    S, M = len(scheds), n_microbatches
    order = pp_cell_order(S, M, direction)

    # A stage has a downstream junction when any stage follows it in this
    # direction's dataflow; those stages' bridge writers are re-tiled once.
    def has_downstream(s: int) -> bool:
        return s < S - 1 if direction == "forward" else s > 0

    views = {s: _fragment_view(sch, src_base if has_downstream(s) else None)
             for s, sch in enumerate(scheds)}

    tasks: list[TaskDescriptor] = []
    fragments: list[Fragment] = []
    bases: list[int] = []
    boundary_tids: list[tuple[int, ...]] = []
    for frag, (s, m) in enumerate(order):
        lab = f"S{s}M{m}"
        cell_meta = {"pp_stage": s, "pp_microbatch": m}
        btids: list[int] = []
        s_up = s - 1 if direction == "forward" else s + 1
        if 0 <= s_up < S:
            junction = m * (S - 1) + min(s, s_up)
            for td in _boundary_tasks(f"S{s_up}M{m}", lab, frag,
                                      src_base, dst_base,
                                      cfgs[s_up], cfgs[s], boundary_split,
                                      kind="stage", junction=junction,
                                      extra_meta=cell_meta):
                td.tid = len(tasks)
                btids.append(td.tid)
                tasks.append(td)
        boundary_tids.append(tuple(btids))
        bases.append(len(tasks))
        for td in views[s][0]:               # fragment-local position order
            c = _clone_task(td, lab, frag, extra_meta=cell_meta)
            c.tid = len(tasks)
            tasks.append(c)
        fragments.append(Fragment(index=frag, label=lab,
                                  tid_lo=bases[frag], tid_hi=len(tasks),
                                  boundary_tids=tuple(btids)))

    deps = _derive_dependencies(tasks)
    events = _allocate_events(tasks, deps)

    queues: dict[tuple[int, str], list[int]] = defaultdict(list)
    for frag, (s, m) in enumerate(order):
        for tid in boundary_tids[frag]:
            queues[(tasks[tid].rank, VTQ)].append(tid)
        fqueues = views[s][1]
        for (rank, qt) in sorted(fqueues):
            queues[(rank, qt)].extend(bases[frag] + t
                                      for t in fqueues[(rank, qt)])

    fused_pipe = resolve_pipeline(fused_pipeline)
    fs = FusedSchedule(
        direction=direction, ep=ep, tasks=tasks, events=events,
        queues=dict(queues),
        opts={"pipeline": fused_pipe.spec(),
              "fragment_pipelines": [list(scheds[s].opts.get("pipeline", []))
                                     for (s, _) in order],
              "fragment_labels": [f.label for f in fragments],
              "boundary_split": boundary_split,
              "pp": {"n_stages": S, "n_microbatches": M,
                     "order": [[s, m] for (s, m) in order]}},
        fragments=tuple(fragments))

    fused_pipe.run(fs, cfgs[0])
    validate_schedule(fs)
    return fs


def compile_pp_fused(cfgs: Sequence[ScheduleConfig], n_microbatches: int,
                     n_stages: Optional[int] = None, *,
                     direction: str = "forward",
                     pipeline=None, pipelines=None,
                     fused_pipeline=("pp_interleave",),
                     boundary_split: int = DEFAULT_BOUNDARY_SPLIT
                     ) -> FusedSchedule:
    """Compile per-stage configs (stage order) into a PP-fused schedule.

    ``cfgs`` gives one config per pipeline stage; a single config is
    replicated to ``n_stages`` (uniform pipeline). Per-stage schedules are
    compiled once (``pipeline="auto"`` resolves per stage, like the unfused
    path) and cloned per microbatch by :func:`fuse_pp_schedules`.
    """
    if direction not in _BRIDGE_BASES:
        raise ValueError(f"direction must be forward|backward, "
                         f"got {direction!r}")
    cfgs = list(cfgs)
    if not cfgs:
        raise ValueError("compile_pp_fused needs at least one config")
    if n_stages is None:
        n_stages = len(cfgs)
    if len(cfgs) == 1 and n_stages > 1:
        cfgs = cfgs * n_stages
    if len(cfgs) != n_stages:
        raise ValueError(f"{len(cfgs)} configs but n_stages={n_stages}")
    if pipelines is None:
        pipelines = [pipeline] * n_stages
    if len(pipelines) != n_stages:
        raise ValueError(f"{n_stages} stages but {len(pipelines)} pipelines")
    builder = (build_moe_ffn_forward if direction == "forward"
               else build_moe_ffn_backward)
    scheds = [compile_schedule(builder(cfg), pipeline=p)
              for cfg, p in zip(cfgs, pipelines)]
    return fuse_pp_schedules(scheds, cfgs, n_microbatches,
                             fused_pipeline=fused_pipeline,
                             boundary_split=boundary_split)


def pp_fragment_cfgs(fs: FusedSchedule, cfgs) -> list:
    """Per-fragment config list (execution order) for
    ``ExecutorState(fragment_cfgs=...)``: ``cfgs`` is per stage."""
    return [cfgs[s] for (s, _) in fs.opts["pp"]["order"]]


def load_pp_forward_state(fs: FusedSchedule, cfgs, st,
                          x_srcs, w1s, w2s) -> None:
    """``cfgs``/``w1s``/``w2s`` per *stage* (stage order); ``x_srcs[m]`` is
    microbatch m's per-rank input list for stage 0. Arrays or tensors; the
    state holds them as fp32 tensors on its device."""
    pp = fs.opts["pp"]
    for (s, _), frag in zip(pp["order"], fs.fragments):
        for r in range(cfgs[s].ep):
            st.set_weight(f"W1#{frag.label}", r, w1s[s][r])
            st.set_weight(f"W2#{frag.label}", r, w2s[s][r])
    for m in range(pp["n_microbatches"]):
        for r in range(cfgs[0].ep):
            st.set_buffer(f"x_src#S0M{m}", r, x_srcs[m][r])


def load_pp_backward_state(fs: FusedSchedule, cfgs, st,
                           dys, fwds, w1s, w2s) -> None:
    """Backward twin: ``dys[m]`` is microbatch m's upstream gradient at the
    last stage; ``fwds[m][s]`` the saved forward dict of cell (s, m)."""
    pp = fs.opts["pp"]
    S = pp["n_stages"]
    for (s, m), frag in zip(pp["order"], fs.fragments):
        lab = frag.label
        for r in range(cfgs[s].ep):
            st.set_weight(f"W1#{lab}", r, w1s[s][r])
            st.set_weight(f"W2#{lab}", r, w2s[s][r])
            st.set_buffer(f"g_saved#{lab}", r, fwds[m][s]["g"][r])
            st.set_buffer(f"h_saved#{lab}", r, fwds[m][s]["h"][r])
            st.set_buffer(f"x_recv_saved#{lab}", r,
                          fwds[m][s]["x_recv"][r])
    for m in range(pp["n_microbatches"]):
        for r in range(cfgs[-1].ep):
            st.set_buffer(f"dy_src#S{S - 1}M{m}", r, dys[m][r])


# ---------------------------------------------------------------------------
# Executor state loaders — fragment-suffixed twins of the *_plan loaders.
# ---------------------------------------------------------------------------

def load_fused_forward_state(fs: FusedSchedule, cfgs, st,
                             x_src, w1s, w2s) -> None:
    """``cfgs``/``w1s``/``w2s`` in execution order (aligned with
    ``fs.fragments``); ``x_src`` is fragment 0's per-rank input list."""
    labels = [f.label for f in fs.fragments]
    for j, (cfg, lab) in enumerate(zip(cfgs, labels)):
        for r in range(cfg.ep):
            st.set_weight(f"W1#{lab}", r, w1s[j][r])
            st.set_weight(f"W2#{lab}", r, w2s[j][r])
    for r in range(cfgs[0].ep):
        st.set_buffer(f"x_src#{labels[0]}", r, x_src[r])


def load_fused_backward_state(fs: FusedSchedule, cfgs, st,
                              dy, fwds, w1s, w2s) -> None:
    """Backward twin: everything in *execution* order (reversed layer
    order), so ``dy`` is the last layer's upstream gradient and ``fwds[j]``
    the saved forward dict of the fragment at execution position j."""
    labels = [f.label for f in fs.fragments]
    for j, (cfg, lab) in enumerate(zip(cfgs, labels)):
        for r in range(cfg.ep):
            st.set_weight(f"W1#{lab}", r, w1s[j][r])
            st.set_weight(f"W2#{lab}", r, w2s[j][r])
            st.set_buffer(f"g_saved#{lab}", r, fwds[j]["g"][r])
            st.set_buffer(f"h_saved#{lab}", r, fwds[j]["h"][r])
            st.set_buffer(f"x_recv_saved#{lab}", r, fwds[j]["x_recv"][r])
    for r in range(cfgs[0].ep):
        st.set_buffer(f"dy_src#{labels[0]}", r, dy[r])
