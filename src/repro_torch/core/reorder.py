"""Reordering pass bodies over legal topological orders (§4.5).

This module holds the *implementations* of the queue-reordering schedule
passes; their registration, naming, and composition live in
``core/passes.py`` (the pass pipeline ``compile_schedule`` executes between
task generation and validation). Every function here permutes *mutually
independent* tasks only — ODG edges, tile ranges, and event semantics are
untouched, and ``validate_schedule`` re-proves legality after the pipeline
runs.

* **RATR (rank-aware task reordering)** — rotate each source rank's
  communication-task order so rank *r* starts sending to destination
  ``(r+1) mod ep`` and walks the ring. Destroys the destination-rank hotspot
  of the naive order (every rank sending to rank 0 first) and balances link
  usage over time (Fig. 6).

* **Cache-guided GMM interleaving** — in the backward graph the two GMM
  branches hanging off a shared input (act_grad/w2_grad consume dispatched
  dY; gate_grad/w1_grad consume dSwiGLU) are topologically independent.
  Interleaving their tiles by expert shortens the reuse distance of the
  shared activations in L2/VMEM instead of streaming one branch end-to-end.

* **Chain interleaving** — place consumer tiles a small lag behind their
  1:1-aligned producers so the producer tile is still L2-resident (§6.1).

* **Critical-rank-first** — hoist comm tasks that feed the compile-time
  critical rank (``CostModel.critical_rank``, the static analogue of the
  simulator's ``straggler_ratio``) to the front of each producer queue's
  comm blocks, so the straggler's dependencies arrive as early as possible.

All passes operate on ragged tile sets from imbalanced RoutingPlans: comm
reorderings sort whatever comm tasks a rank actually emits (empty cells
simply don't appear), and GMM interleaving keys on (expert, m) metadata that
survives variable-extent tiling.
"""

from __future__ import annotations

from collections import defaultdict

from .odg import ScheduleConfig, CTQ, VTQ


def reorder_comm_blocks(sched, q: list[int], sort_key) -> list[int]:
    """Sort each contiguous same-op block of comm tasks in queue ``q``.

    Comm tasks inside one operator's block are mutually independent (they
    write disjoint remote ranges), so any permutation is legal; relative
    order against non-comm tasks and across blocks is preserved. The sort is
    stable, so passes compose: a later pass's partial key refines, rather
    than destroys, an earlier pass's order.
    """
    new_q: list[int] = []
    block: list[int] = []
    block_op = None

    def flush():
        nonlocal block, block_op
        if block:
            block.sort(key=sort_key)
            new_q.extend(block)
            block, block_op = [], None

    for tid in q:
        td = sched.tasks[tid]
        is_comm = (td.task_type == "put_mem_signal" and td.dst_rank >= 0)
        if is_comm and (block_op in (None, td.op_name)):
            block.append(tid)
            block_op = td.op_name
        else:
            flush()
            if is_comm:
                block.append(tid)
                block_op = td.op_name
            else:
                new_q.append(tid)
    flush()
    return new_q


def ratr_order(rank: int, ep: int) -> list[int]:
    """Destination visit order for a source rank under RATR."""
    return [(rank + 1 + i) % ep for i in range(ep)]


def apply_ratr(sched, cfg: ScheduleConfig) -> None:
    """Ring-rotate each rank's comm blocks; fragment- and node-aware.

    On multi-fragment schedules the ring start additionally rotates by the
    task's fragment index, so consecutive layers at the same source rank
    begin their walks at *different* destinations — without this, a fused
    schedule re-creates the transient hotspot RATR removes, once per layer
    boundary. Single-fragment schedules (fragment 0 everywhere) reorder
    byte-identically to the original RATR.

    With a :class:`~repro_torch.core.hardware.Topology` the ring rotates over
    *nodes* first: rank r walks remote nodes starting at the next node on
    the node ring, visiting same-node destinations last. Cross-node puts
    are the scarce resource (the NIC), so every source starts pushing onto
    a *different* node's ingress while the cheap intra-node copies fill
    the tail; within one destination node, the rank-level ring still
    staggers ingress ports. Without a topology the key degenerates to the
    original rank ring (n_nodes=1 ⇒ node term constant).
    """
    ep = cfg.ep
    topo = getattr(cfg, "topology", None)
    nodes = topo.n_nodes(ep) if topo is not None else 1
    node_of = (topo.node_of if topo is not None else (lambda r: 0))
    for (rank, qtype), q in sched.queues.items():
        if qtype != VTQ:
            continue

        def key(tid, rank=rank):
            td = sched.tasks[tid]
            frag = td.meta.get("fragment", 0)
            return ((node_of(td.dst_rank) - node_of(rank) - 1 - frag)
                    % nodes if nodes > 1 else 0,
                    (td.dst_rank - rank - 1 - frag) % ep,
                    td.meta.get("expert", 0))

        sched.queues[(rank, qtype)] = reorder_comm_blocks(sched, q, key)


def apply_hier_dispatch(sched, cfg: ScheduleConfig) -> None:
    """Order two-level dispatch stage puts by node-ring distance.

    Within each comm block, hierarchical stage tasks (the intra-node
    ``gather`` puts and the aggregated ``xnode`` puts emitted by
    ``dispatch_mode="hier"``) are hoisted ahead of ordinary puts and
    walked over destination *nodes* ring-wise from the sender's own node —
    the node-level analogue of RATR: gathers that feed the most distant
    leader's aggregation issue first, so the slow inter-node messages can
    start as early as their staging rows land. Tasks without a ``stage``
    tag sort under one constant key, so the stable sort leaves flat
    schedules byte-identical (the pass is a registered no-op there).
    """
    topo = getattr(cfg, "topology", None)
    if topo is None:
        return
    nodes = topo.n_nodes(cfg.ep)
    for (rank, qtype), q in sched.queues.items():
        if qtype != VTQ:
            continue
        my_node = topo.node_of(rank)

        def key(tid, my_node=my_node):
            td = sched.tasks[tid]
            if td.meta.get("stage") not in ("gather", "xnode"):
                return (1, 0)
            return (0, (td.meta.get("dst_node", 0) - my_node - 1) % nodes)

        sched.queues[(rank, qtype)] = reorder_comm_blocks(sched, q, key)


def apply_gmm_interleave(sched, cfg: ScheduleConfig) -> None:
    """Interleave independent backward GMM branch pairs by expert."""
    for (rank, qtype), q in sched.queues.items():
        if qtype != CTQ:
            continue
        # Group consecutive CTQ ops by their shared-input branch tag.
        by_branch: dict[str, list[int]] = defaultdict(list)
        order: list[str] = []
        for tid in q:
            br = sched.tasks[tid].meta.get("branch", f"_solo{tid}")
            if br not in by_branch:
                order.append(br)
            by_branch[br].append(tid)

        new_q: list[int] = []
        for br in order:
            tids = by_branch[br]
            ops = []
            for tid in tids:
                op = sched.tasks[tid].op_name
                if op not in ops:
                    ops.append(op)
            if br.startswith("_solo") or len(ops) < 2:
                new_q.extend(tids)
                continue
            # Interleave: same (expert, m) tiles of the branch's ops adjacent.
            keyed = sorted(tids, key=lambda tid: (
                sched.tasks[tid].meta.get("expert", 0),
                sched.tasks[tid].meta.get("m", 0),
                ops.index(sched.tasks[tid].op_name)))
            new_q.extend(keyed)
        sched.queues[(rank, qtype)] = new_q


def _interleave_aligned_queue(sched, key, lag: int) -> bool:
    """Lag-interleave one queue's op streams if they are 1:1 aligned.

    Produces [p0 … p_{lag-1}, c0, p_lag, c1, …] per op pair: each consumer
    tile sits ``lag`` entries behind its producer. Returns False (queue
    untouched) when the queue has < 2 ops or its op streams differ in
    length.
    """
    q = sched.queues.get(key, [])
    by_op: dict[str, list[int]] = {}
    order: list[str] = []
    for tid in q:
        op = sched.tasks[tid].op_name
        if op not in by_op:
            order.append(op)
        by_op.setdefault(op, []).append(tid)
    if len(order) < 2:
        return False
    counts = {len(v) for v in by_op.values()}
    if len(counts) != 1:
        return False            # not 1:1 aligned — leave as-is
    n = counts.pop()
    streams = [by_op[op] for op in order]
    k = len(streams)
    new_q: list[int] = []
    emitted = [0] * k
    while len(new_q) < n * k:
        # Emit from the deepest stream whose predecessor is ≥ lag ahead
        # (or finished); otherwise advance the head stream.
        for si in range(k - 1, -1, -1):
            if emitted[si] >= n:
                continue
            if si == 0 or emitted[si - 1] >= min(n, emitted[si] + lag):
                new_q.append(streams[si][emitted[si]])
                emitted[si] += 1
                break
    sched.queues[key] = new_q
    return True


def apply_chain_interleave(sched, lag: int = 50) -> None:
    """Place consumer tiles a small *lag* behind their aligned producers
    (§6.1).

    For 1:1-aligned elementwise chains the queue order becomes
    [p0 … p_{lag-1}, c0, p_lag, c1, …]: close enough that the producer's
    tile is still L2-resident when the consumer reads it, but far enough
    that in-order-fetching workers never block on a not-yet-ready consumer
    (lag ≈ worker-pool width). Op-major order instead streams the whole
    intermediate through the cache before any consumer runs."""
    for key in list(sched.queues):
        _interleave_aligned_queue(sched, key, lag)


def apply_critical_rank_first(sched, cfg: ScheduleConfig, *,
                              threshold: float | None = None,
                              lag: int = 0) -> None:
    """Prioritize the compile-time critical rank (§4.5 extension).

    The cost model prices every CTQ tile at compile time; when the
    most-loaded rank's cube time exceeds ``threshold`` × the EP-group mean,
    two reorderings fire:

    1. *Dependency-feeding hoist* — each rank's VTQ comm blocks are stably
       re-sorted so transfers destined to the critical rank go first: on
       producer peers this feeds the straggler's dependency events as early
       as the links allow, and on the critical rank itself its rank-local
       dispatch copy moves ahead of sends to non-critical peers. Composes
       with RATR: a stable partition keeps the anti-hotspot ring order
       among non-critical destinations.

    2. *Starved-chain interleave* — when the critical rank's cube work is
       concentrated in one dominant expert (the remaining CTQ tiles cannot
       even fill the AIC pool), op-major order leaves its workers parked on
       the dominant chain while downstream tiles sit deep in the queue.
       If the rank's CTQ is a 1:1-aligned op chain, interleave it with a
       lag of twice the AIC pool width — deep enough that by the time an
       in-order worker fetches a consumer tile, its producer (2×pool
       entries ahead) has usually retired, so the interleave never parks
       workers that op-major order would have kept busy (on chains shorter
       than the lag it degenerates to op-major — a no-op). With enough
       sibling-expert work to keep the pool busy the interleave is skipped
       entirely — parking workers on not-yet-ready consumers would then
       *cost* throughput.
    """
    from .costmodel import CostModel
    from .passes import CRIT_STRAGGLER_THRESHOLD
    if threshold is None:
        threshold = CRIT_STRAGGLER_THRESHOLD
    cost = CostModel(l2=False)
    if len({td.meta.get("fragment", 0) for td in sched.tasks}) > 1:
        # Fragment scope: each fused fragment carries its own routing plan,
        # so the straggler is per-fragment — hoist each fragment's combine/
        # dispatch blocks toward *that fragment's* critical rank. The
        # starved-chain interleave is skipped here: a fused CTQ mixes
        # fragments, so the 1:1-aligned single-chain precondition it relies
        # on never holds across the mix.
        crit_by_frag = {f: c for f, (ratio, c)
                        in cost.fragment_critical_ranks(sched).items()
                        if c >= 0 and ratio > threshold}
        if not crit_by_frag:
            return

        def fkey(tid):
            td = sched.tasks[tid]
            c = crit_by_frag.get(td.meta.get("fragment", 0))
            return 0 if (c is not None and td.dst_rank == c) else 1

        for (rank, qtype), q in sched.queues.items():
            if qtype != VTQ:
                continue
            sched.queues[(rank, qtype)] = reorder_comm_blocks(sched, q, fkey)
        return
    ratio, crit = cost.critical_rank(sched)
    if crit < 0 or ratio <= threshold:
        return
    for (rank, qtype), q in sched.queues.items():
        if qtype != VTQ:
            continue
        sched.queues[(rank, qtype)] = reorder_comm_blocks(
            sched, q,
            lambda tid: 0 if sched.tasks[tid].dst_rank == crit else 1)

    ctq = sched.queues.get((crit, CTQ))
    if not ctq:
        return
    # Dominant-expert concentration: tiles outside the costliest expert.
    by_expert: dict[int, float] = defaultdict(float)
    for tid in ctq:
        td = sched.tasks[tid]
        by_expert[td.meta.get("expert", -1)] += cost.task_us(td)
    dominant = max(by_expert, key=by_expert.get)
    other_tiles = sum(1 for tid in ctq
                      if sched.tasks[tid].meta.get("expert", -1) != dominant)
    if other_tiles >= cost.hw.num_aic:
        return
    _interleave_aligned_queue(sched, (crit, CTQ),
                              lag=lag or 2 * cost.hw.num_aic)


def apply_fuse_boundary(sched, cfg: ScheduleConfig) -> None:
    """Interleave fragment-boundary comm into the neighbor's AIC shadow.

    In a fused schedule, fragment f's combine tiles are the producers that
    gate fragment f+1's dispatch (through the per-rank LayerBoundary
    remap): the sooner all combines *into* rank r complete, the sooner r's
    boundary fires and its next-layer dispatch issues — overlapping the
    other ranks' still-running GMM and combine tails. Within each combine
    block, stably hoist tiles returning to the ranks with the most
    downstream dispatch traffic (they sit deepest on the next fragment's
    critical path). Dispatch blocks and the last fragment's combines see a
    constant key, so the stable sort leaves them — and any single-fragment
    schedule — untouched.
    """
    dn_dispatch = defaultdict(float)     # (fragment, src rank) -> bytes
    for td in sched.tasks:
        if (td.task_type == "put_mem_signal"
                and td.meta.get("comm_kind") == "dispatch"):
            dn_dispatch[(td.meta.get("fragment", 0), td.rank)] += \
                td.comm_bytes
    if not dn_dispatch:
        return

    def key(tid):
        td = sched.tasks[tid]
        if td.meta.get("comm_kind") != "combine":
            return (0.0,)
        frag = td.meta.get("fragment", 0)
        return (-dn_dispatch.get((frag + 1, td.dst_rank), 0.0),)

    for (rank, qtype), q in sched.queues.items():
        if qtype != VTQ:
            continue
        sched.queues[(rank, qtype)] = reorder_comm_blocks(sched, q, key)


def apply_pp_interleave(sched, cfg: ScheduleConfig) -> None:
    """PP-aware twin of :func:`apply_fuse_boundary` for stage-fused
    schedules.

    In a PP-fused taskflow the consumer of cell (s, m)'s combine traffic is
    the *same-microbatch next-stage* cell — (s+1, m) forward, (s-1, m)
    backward — not the next execution position (which under the 1F1B wave
    order is usually another microbatch of a different stage). Resolve the
    true downstream cell through ``pp_stage``/``pp_microbatch`` metadata
    and stably hoist, within each combine block, the tiles returning to
    ranks with the heaviest downstream dispatch: those feed the
    StageBoundary handoff that gates the next stage. Like
    ``fuse_boundary``, this only reorders *within* contiguous comm blocks
    — it can never hoist a task ahead of a same-queue producer, so the
    head-blocking validation order stays legal. No-op without PP metadata.
    """
    dn_dispatch = defaultdict(float)     # ((stage, microbatch), rank) -> B
    for td in sched.tasks:
        if (td.task_type == "put_mem_signal"
                and td.meta.get("comm_kind") == "dispatch"
                and "pp_stage" in td.meta):
            cell = (td.meta["pp_stage"], td.meta.get("pp_microbatch", 0))
            dn_dispatch[(cell, td.rank)] += td.comm_bytes
    if not dn_dispatch:
        return
    step = 1 if sched.direction == "forward" else -1

    def key(tid):
        td = sched.tasks[tid]
        if (td.meta.get("comm_kind") != "combine"
                or "pp_stage" not in td.meta):
            return (0.0,)
        dn_cell = (td.meta["pp_stage"] + step,
                   td.meta.get("pp_microbatch", 0))
        return (-dn_dispatch.get((dn_cell, td.dst_rank), 0.0),)

    for (rank, qtype), q in sched.queues.items():
        if qtype != VTQ:
            continue
        sched.queues[(rank, qtype)] = reorder_comm_blocks(sched, q, key)


def apply_reorderings(sched, cfg: ScheduleConfig, *, ratr: bool,
                      gmm_interleave: bool,
                      chain_interleave: bool = False) -> None:
    """Back-compat shim for the pre-pipeline boolean-flag API."""
    from .passes import pipeline_from_flags
    pipeline_from_flags(ratr=ratr, gmm_interleave=gmm_interleave,
                        chain_interleave=chain_interleave).run(sched, cfg)
