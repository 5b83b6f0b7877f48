"""Cost-model-guided pipeline auto-selection.

The paper's thesis is that the tile-level taskflow is priced *at compile
time* — the ``--sched-sweep`` table showed that which pass pipeline wins
depends on the routing profile (``critical_rank_first`` on concentrated
hotspots, branch interleaving on skewed backward graphs, plain RATR on the
balanced grid), but until now a human read that table and hardcoded the
pick. This module closes the loop Piper-style: ``auto_pipeline`` enumerates
the canonical candidate space (``core.passes.SCHED_PIPELINES`` plus a small
``gmm_m_split`` budget grid), prices every candidate with the *same*
:class:`~repro_torch.core.costmodel.CostModel` the passes and simulator share, and
returns the predicted-best ``(Pipeline, ScheduleConfig)`` — no simulator run,
no schedule compile.

Pricing never generates the real task set (dependency derivation on a dense
plan costs ~1s; selection must stay O(ms) so the dropless path can afford it
per batch). Instead a *synthetic* cube task set is built straight from the
``RoutingPlan`` — one ``TaskDescriptor`` per (rank, expert, GMM op) with the
exact flop/byte formulas of ``core/tasks.py`` — and handed to
``CostModel.rank_cube_us`` / ``critical_rank``, the static straggler
analysis the ``critical_rank_first`` pass itself consumes. Plan-profile
features (skew ratio, sparsity, hotspot concentration) prune the grid:
re-tiling candidates are only generated for starved-hotspot plans, and
pass effects that are gated no-ops (``gmm_interleave`` forward,
``critical_rank_first`` below its straggler threshold) are priced as such.

Resolution points (the literal string ``"auto"`` never escapes them):

* ``compile_schedule(odg, pipeline="auto")`` — resolves the pipeline with
  the tiling pinned (the ODG's task set is already built);
* ``SSCCache.key`` / ``SSCCache.get_or_compile`` — resolve pipeline *and*
  tiling, so cached schedules are keyed by the resolved spec and an
  ``"auto"`` request cache-hits the equivalent explicit request;
* ``launch/hillclimb.py --sched-sweep`` — the ``auto`` row and the
  ``--selector-report`` predicted-vs-simulated accuracy table.

Selection is deterministic (equal plans resolve to equal specs — an SSC
cache invariant) and memoized on the hashable ``ScheduleConfig``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np

from .costmodel import CostModel
from .odg import CTQ, ScheduleConfig
from .passes import CRIT_STRAGGLER_THRESHOLD, SCHED_PIPELINES, Pipeline
from .routing import RoutingPlan
from .tasks import TaskDescriptor

AUTO = "auto"
# A (rank, expert) block holding more than this fraction of all routed rows
# marks a concentrated hotspot (RATR's ring rotation stops mattering: all
# traffic converges on one destination anyway).
_CONC_HOTSPOT = 0.5
# Expert-level imbalance below which backward branch interleaving is priced
# as a small loss (tiny uniform blocks: interleaving only stretches the
# producer→consumer reuse distance the chain order already had).
_IL_SKEW_MIN = 1.25
# Calibrated effect sizes (fractions of the critical rank's cube-pool time),
# fitted against the ep=8 sweep (launch/hillclimb.py --sched-sweep) and
# re-checked at fixture scale by tests/test_autoselect.py.
_IL_GAIN = 0.06          # backward branch interleave, imbalanced plans
_IL_LOSS = 0.02          # backward branch interleave, balanced plans
_CRIT_CHAIN_GAIN = 0.25  # starved-chain interleave on the critical rank
_CRIT_HOIST_LOSS = 0.25  # peer-latency trade of the comm hoist (graded skew)
# Observed rank bias at which the comm hoist flips to a win: when the
# critical rank is critical because it is *measured* slow (not because its
# plan cells are heavy), its peers finish early anyway — hoisting the
# straggler's comm ahead of their compute costs the peers slack they have.
_BIAS_CRIT = 1.5


@dataclasses.dataclass(frozen=True)
class PlanFeatures:
    """The plan profile that prunes the candidate grid."""

    skew: float          # max/mean recv rows over ranks (straggler potential)
    expert_skew: float   # max/mean rows over (rank, expert) slots
    sparsity: float      # fraction of empty (src, dst, expert) cells
    conc: float          # largest (rank, expert) block / total routed rows
    hot_rows: int        # rows of that largest block
    total_rows: int

    @property
    def balanced(self) -> bool:
        return self.expert_skew <= _IL_SKEW_MIN

    @property
    def hotspot(self) -> bool:
        return self.conc >= _CONC_HOTSPOT


def plan_features(plan: RoutingPlan) -> PlanFeatures:
    c = np.asarray(plan.counts, dtype=np.int64)
    total = int(c.sum())
    blocks = c.sum(axis=0)                       # [dst rank, expert] rows
    hot = int(blocks.max()) if blocks.size else 0
    return PlanFeatures(
        skew=plan.rank_imbalance(),
        expert_skew=plan.expert_imbalance(),
        sparsity=float((c == 0).mean()),
        conc=hot / total if total else 0.0,
        hot_rows=hot,
        total_rows=total,
    )


class _TaskSetView:
    """Duck-typed stand-in for a Schedule: just ``tasks`` + ``ep``.

    ``CostModel.rank_cube_us`` / ``critical_rank`` only touch these two
    attributes, so the selector can run the same static straggler analysis
    the ``critical_rank_first`` pass uses — on a synthetic task set built
    straight from the plan, without compiling a schedule.
    """

    def __init__(self, tasks: list[TaskDescriptor], ep: int):
        self.tasks = tasks
        self.ep = ep


# Cube flops per routed row for each GMM op of the two graphs, as emitted by
# core/tasks.py (`2 * rows * K * N` with K/N in elements): forward runs
# GMM1 [d → 2f] + GMM2 [f → d]; backward runs act_grad [d → f] +
# w2_grad [d × f] + gate_grad [2f → d] + w1_grad [2f × d].
def _gmm_ops(direction: str, d: int, f: int) -> list[tuple[str, float]]:
    if direction == "forward":
        return [("gmm1", 2.0 * d * 2 * f), ("gmm2", 2.0 * f * d)]
    return [("act_grad", 2.0 * d * f), ("w2_grad", 2.0 * d * f),
            ("gate_grad", 2.0 * 2 * f * d), ("w1_grad", 2.0 * 2 * f * d)]


def cube_taskset(plan: RoutingPlan, cfg: ScheduleConfig,
                 direction: str) -> _TaskSetView:
    """Synthetic per-(rank, expert, op) CTQ task set mirroring tasks.py.

    Tiling does not change a rank's cube-time *sum* (``task_us`` is linear
    in flops at fixed residency), so one task per expert block prices
    ``rank_cube_us`` exactly while staying O(ep * e_loc) objects.
    """
    d, f = cfg.d_model, cfg.d_ff
    ops = _gmm_ops(direction, d, f)
    tds: list[TaskDescriptor] = []
    for r in range(plan.ep):
        for e in range(plan.e_loc):
            rows = plan.expert_rows(r, e)
            if rows == 0:
                continue
            for which, flops_per_row in ops:
                tds.append(TaskDescriptor(
                    task_type="GMM", queue_type=CTQ, rank=r,
                    flops=flops_per_row * rows,
                    meta={"expert": e, "which": which}))
    return _TaskSetView(tds, plan.ep)


def _comm_vec_us(plan: RoutingPlan, cfg: ScheduleConfig, direction: str,
                 cost: CostModel) -> tuple[np.ndarray, np.ndarray]:
    """Per-rank (link_us, vector_us) static estimates.

    ``link_us`` prices each rank's total off-rank row traffic — dispatch
    rows in plus combine/return rows out, which are row-for-row symmetric
    in both graphs, so one combined per-rank link term covers ingress and
    egress alike. Vector time prices the SwiGLU/SwiGLU-grad tile stream on
    the AIV pool's aggregate bandwidth.
    """
    hw = cost.hw
    d, f, db = cfg.d_model, cfg.d_ff, cfg.dtype_bytes
    c = np.asarray(plan.counts, dtype=np.float64)
    recv = c.sum(axis=(0, 2))                    # rows landing on each rank
    sent = c.sum(axis=(1, 2))                    # rows leaving each source
    local = np.diag(c.sum(axis=2)).copy()        # rank-local rows
    row_b = d * db
    link_bw = hw.link_gbps * 1e3                 # bytes / us
    link = ((recv - local) + (sent - local)) * row_b / link_bw
    # SwiGLU (fwd: read 2f, write f) / SwiGLU_grad (bwd: read f + 2f saved,
    # write 2f) rows per rank on the AIV pool.
    if direction == "forward":
        bytes_per_row = (2 * f + f) * db
    else:
        bytes_per_row = (f + 2 * f + 2 * f) * db
    vec = recv * bytes_per_row / (hw.aiv_gbps * 1e3)
    return link, vec


def _comm_topo_us(plan: RoutingPlan, cfg: ScheduleConfig,
                  cost: CostModel) -> np.ndarray:
    """Per-rank comm time under a Topology: the busiest link class.

    Walks the exact message set the candidate's dispatch mode emits —
    per-cell puts, plus gather/aggregated-xnode messages from the same
    :class:`~repro_torch.core.routing.HierDispatch` geometry ``tasks.py`` fills
    from — and prices each on its link class (per-message hop latency +
    bytes over the class bandwidth; local stays HBM-bound). Egress and
    ingress accumulate separately per (rank, class) — mirroring the
    simulator's clocks — and a rank's bound is its worst single clock:
    the NIC and the intra-node bus are independent resources.
    """
    from repro_torch.parallel.compression import int8_wire_bytes

    topo, hw = cfg.topology, cost.hw
    hier = cfg.hier
    row_b = cfg.d_model * cfg.dtype_bytes
    ep = plan.ep
    eg: dict[tuple[int, str], float] = {}
    ing: dict[tuple[int, str], float] = {}

    def put(a: int, b: int, nbytes: float, extra: float = 0.0) -> None:
        cls = topo.link_class(a, b)
        if cls == "local":
            t = nbytes / (hw.hbm_gbps * 1e3)
        else:
            t = topo.latency_us(cls) + nbytes / (topo.bw_gbps(cls) * 1e3)
        t += extra
        eg[(a, cls)] = eg.get((a, cls), 0.0) + t
        ing[(b, cls)] = ing.get((b, cls), 0.0) + t

    c = np.asarray(plan.counts, dtype=np.int64)
    for s in range(ep):
        for d in range(ep):
            for e in range(plan.e_loc):
                cnt = int(c[s, d, e])
                if cnt == 0:
                    continue
                put(d, s, cnt * row_b)          # combine return, always flat
                if (hier is not None
                        and not hier.same_node(s, d)
                        and hier.aggregated(hier.node_of(s), d, e)):
                    put(s, hier.leader(hier.node_of(s), d, e), cnt * row_b)
                else:
                    put(s, d, cnt * row_b)
    if hier is not None:
        for leader in range(ep):
            for (d, e, _srcs, total) in hier.stage_groups(leader):
                nb = total * row_b
                wire, qdq = nb, 0.0
                if cfg.xnode_compress == "int8":
                    wire = int8_wire_bytes(nb, cfg.dtype_bytes)
                    qdq = 2 * nb / (hw.l2_read_x_hbm * hw.hbm_gbps * 1e3)
                put(leader, d, wire, extra=qdq)

    link = np.zeros(ep)
    for (r, _cls), t in eg.items():
        link[r] = max(link[r], t)
    for (r, _cls), t in ing.items():
        link[r] = max(link[r], t)
    return link


def _crit_tiles(plan: RoutingPlan, cfg: ScheduleConfig,
                rank: int) -> tuple[int, int, int]:
    """(dominant-expert tile count, other-expert tile count, max tile rows)
    for ``rank`` under the candidate tiling — the exact quantities the
    ``critical_rank_first`` starved-chain gate checks at compile time."""
    tiles = plan.gmm_tiles(rank, cfg.gmm_m_split, cfg.gmm_split_mode,
                           cfg.tile_atom_nodes, cfg.tile_agg_rows)
    if not tiles:
        return 0, 0, 0
    rows_by_e: dict[int, int] = {}
    count_by_e: dict[int, int] = {}
    max_rows = 0
    for (e, _m, lo, hi) in tiles:
        rows_by_e[e] = rows_by_e.get(e, 0) + (hi - lo)
        count_by_e[e] = count_by_e.get(e, 0) + 1
        max_rows = max(max_rows, hi - lo)
    dom = max(rows_by_e, key=rows_by_e.get)
    n_dom = count_by_e[dom]
    n_other = sum(v for e, v in count_by_e.items() if e != dom)
    return n_dom, n_other, max_rows


@dataclasses.dataclass(frozen=True)
class CandidateScore:
    """One priced candidate of the selection grid."""

    tag: str                     # SCHED_PIPELINES name (+ ":m<split>" suffix)
    pipeline: Pipeline
    cfg: ScheduleConfig
    predicted_us: float


@dataclasses.dataclass(frozen=True)
class AutoChoice:
    """Full selector output: the pick plus its evidence."""

    pipeline: Pipeline
    cfg: ScheduleConfig
    predicted_us: float
    features: PlanFeatures
    scores: tuple[CandidateScore, ...]   # every priced candidate, best first

    @property
    def tag(self) -> str:
        return self.scores[0].tag if self.scores else "naive"


@dataclasses.dataclass(frozen=True)
class _PriceContext:
    """Everything about a (config, direction) that pipelines cannot change.

    Built once per candidate tiling and shared across the per-pipeline
    pricing loop — the synthetic task set, the per-rank cube/comm/vector
    aggregates and the critical-rank tile census are all independent of
    pass order (passes only permute queues).
    """

    feats: PlanFeatures
    crit_us: float           # critical rank's total cube time
    ratio: float             # compile-time straggler ratio
    crit: int                # critical rank id
    base_us: float           # max over ranks of the pool/link bounds
    link_max: float          # busiest rank's off-rank comm time
    link_mean: float
    drain_us: float          # largest-tile serialization tail
    n_dom: int               # dominant-expert tile count on the crit rank
    n_other: int             # other-expert tile count on the crit rank


def _price_context(cfg: ScheduleConfig, direction: str,
                   cost: CostModel) -> _PriceContext:
    hw = cost.hw
    plan = cfg.routing
    feats = plan_features(plan)
    view = cube_taskset(plan, cfg, direction)
    cube = cost.rank_cube_us(view)
    ratio, crit = cost.critical_rank(view)
    link, vec = _comm_vec_us(plan, cfg, direction, cost)
    if cfg.topology is not None:
        # Per-link-class pricing replaces the flat uniform-link estimate:
        # the candidate's real message set (incl. two-level dispatch
        # aggregation and compression) on heterogeneous links.
        link = _comm_topo_us(plan, cfg, cost)
    per_rank = [max(cube[r] / hw.num_aic, vec[r] / hw.num_aiv,
                    float(link[r]))
                for r in range(plan.ep)]
    # Largest-tile drain on the critical rank: one AIC core owns one tile,
    # so the last tile of the dominant chain serializes after the pool
    # drains — the term the gmm_m_split budget grid trades against.
    n_dom, n_other, max_tile_rows = _crit_tiles(plan, cfg, max(crit, 0))
    flops_row = max(f for _, f in _gmm_ops(direction, cfg.d_model, cfg.d_ff))
    drain = cost.task_us(TaskDescriptor(
        task_type="GMM", queue_type=CTQ, rank=max(crit, 0),
        flops=flops_row * max_tile_rows))
    return _PriceContext(
        feats=feats, crit_us=cube.get(crit, 0.0), ratio=ratio, crit=crit,
        base_us=max(per_rank) if per_rank else 0.0,
        link_max=float(link.max()) if link.size else 0.0,
        link_mean=float(link.mean()) if link.size else 0.0,
        drain_us=drain, n_dom=n_dom, n_other=n_other)


def predict_makespan_us(cfg: ScheduleConfig, direction: str,
                        pipeline_names, cost: Optional[CostModel] = None,
                        ctx: Optional[_PriceContext] = None) -> float:
    """Static makespan estimate of one (tiling, pipeline) candidate.

    Structural lower-bound terms (cube pool, vector pool, per-rank links,
    largest-tile drain) from the cost model, plus per-pass adjustments whose
    *gating* replicates each pass's own compile-time conditions. Absolute
    values undershoot the simulator (no queue/startup chaining is modeled);
    candidate *ordering* is what selection consumes, and the
    ``--selector-report`` table tracks the residual accuracy.

    ``ctx`` shares the pipeline-independent aggregates across a candidate
    loop (the selector prices every ``SCHED_PIPELINES`` entry against one
    :func:`_price_context` per tiling).
    """
    cost = cost or CostModel(l2=False)
    hw = cost.hw
    if ctx is None:
        ctx = _price_context(cfg, direction, cost)
    feats = ctx.feats
    names = tuple(pipeline_names)
    t = ctx.base_us + ctx.drain_us

    crit_cube_pool = ctx.crit_us / hw.num_aic
    fires = ctx.ratio > CRIT_STRAGGLER_THRESHOLD and ctx.crit >= 0
    starved = (fires and ctx.n_other < hw.num_aic
               and ctx.n_dom > 2 * hw.num_aic)
    il_active = ("gmm_interleave" in names and direction == "backward"
                 and feats.total_rows > 0)

    if "ratr" not in names and not feats.hotspot:
        # Naive dst-major order convoys every source onto rank 0's ingress
        # first; under a concentrated hotspot all traffic converges anyway.
        t += ctx.link_max / max(1, cfg.ep)

    if il_active:
        if feats.balanced:
            t += _IL_LOSS * crit_cube_pool
        else:
            t -= _IL_GAIN * crit_cube_pool

    biased = (cost.rank_bias is not None and ctx.crit >= 0
              and ctx.crit < len(cost.rank_bias)
              and cost.rank_bias[ctx.crit] >= _BIAS_CRIT)

    if "critical_rank_first" in names and fires:
        if il_active:
            # The branch interleave already owns the critical rank's CTQ
            # order; stacking the starved-chain interleave on top re-sorts
            # it away from the branch-paired order (sweep: "all" trails
            # "ratr+gmm_il" backward under concentrated hotspots).
            t += _IL_LOSS * crit_cube_pool
        elif starved:
            # Lag-interleaving the dominant chain overlaps its consumer op
            # with the tail of the producer chain (lag = 2 * pool width).
            t -= (_CRIT_CHAIN_GAIN * crit_cube_pool
                  * max(0.0, 1.0 - 2 * hw.num_aic / max(1, ctx.n_dom)))
        elif biased:
            # Observed-slow critical rank: peers have measured slack, so
            # hoisting the straggler's comm ahead of peer compute is free —
            # the peer-latency trade that costs on plan-driven skew wins.
            t -= _CRIT_HOIST_LOSS * ctx.link_mean
        elif not feats.hotspot:
            # Comm hoist trades peer latency for straggler latency; on
            # graded skew the peers' loss wins (sweep: skewed scenarios).
            t += _CRIT_HOIST_LOSS * ctx.link_mean

    return max(t, 0.0)


def _candidate_cfgs(cfg: ScheduleConfig, starved: bool,
                    allow_retile: bool) -> list[ScheduleConfig]:
    """The gmm_m_split / gmm_split_mode budget grid, feature-pruned.

    Re-tiling is only worth pricing when a starved hotspot chain exists
    (finer tiles shrink the last-tile drain *and* give the starved-chain
    interleave room); everywhere else the caller's tiling is kept, so
    selection prices |SCHED_PIPELINES| candidates, not a cross product.
    """
    cfgs = [cfg]
    if allow_retile and starved:
        m2 = min(2 * max(1, cfg.gmm_m_split), 4 * 64)
        if m2 > cfg.gmm_m_split:
            # source_aligned boundaries are legal for arbitrary plans; a
            # starved hotspot is by construction imbalanced, so never force
            # "even".
            cfgs.append(dataclasses.replace(cfg, gmm_m_split=m2,
                                            gmm_split_mode="source_aligned"))
    return cfgs


def _dispatch_variants(cfgs: list[ScheduleConfig],
                       allow_retile: bool) -> list[ScheduleConfig]:
    """Expand the grid with two-level-dispatch variants when a Topology is
    present.

    Hier changes the task *structure* (staging tensors, xnode ops, node-atom
    tiling), so it only enumerates under ``allow_retile`` — the SSC path,
    which rebuilds the ODG from the returned config. Variants are skipped
    when the plan's cross-node groups all stay on the direct path (the
    aggregation threshold says flat is optimal — the candidates would price
    identically and only add tie noise). The compressed variant rides the
    same geometry with int8 inter-node wire bytes.
    """
    out = list(cfgs)
    if not allow_retile:
        return out
    for base in cfgs:
        if base.topology is None or base.dispatch_mode != "flat":
            continue
        h = dataclasses.replace(base, dispatch_mode="hier",
                                gmm_split_mode="source_aligned")
        if not any(h.hier.n_stage_groups(r) for r in range(h.ep)):
            continue
        out.append(h)
        out.append(dataclasses.replace(h, xnode_compress="int8"))
    return out


@functools.lru_cache(maxsize=512)
def _select(cfg: ScheduleConfig, direction: str, allow_retile: bool,
            cost: CostModel) -> AutoChoice:
    hw = cost.hw

    # Starved-chain probe at the caller's tiling decides whether the
    # budget grid is worth enumerating at all; its context is reused to
    # price the un-retiled candidates (pipelines can't change it).
    base_ctx = _price_context(cfg, direction, cost)
    feats = base_ctx.feats
    fires = base_ctx.ratio > CRIT_STRAGGLER_THRESHOLD and base_ctx.crit >= 0
    starved = fires and base_ctx.n_other < hw.num_aic and feats.hotspot

    scores: list[CandidateScore] = []
    grid = _dispatch_variants(_candidate_cfgs(cfg, starved, allow_retile),
                              allow_retile)
    for cand_cfg in grid:
        ctx = (_price_context(cand_cfg, direction, cost)
               if cand_cfg != cfg else base_ctx)
        hier_cand = cand_cfg.dispatch_mode == "hier"
        for tag, spec in SCHED_PIPELINES.items():
            names = tuple(spec)
            if not fires and "critical_rank_first" in names:
                # The pass is a gated no-op below the straggler threshold;
                # pricing it would only duplicate its crit-less twin.
                continue
            label = tag
            if cand_cfg.gmm_m_split != cfg.gmm_m_split:
                label += f":m{cand_cfg.gmm_m_split}"
            if hier_cand:
                names = names + ("hier_dispatch",)
                label += (":hier+c" if cand_cfg.xnode_compress else ":hier")
            scores.append(CandidateScore(
                tag=label, pipeline=Pipeline.of(*names), cfg=cand_cfg,
                predicted_us=predict_makespan_us(cand_cfg, direction, names,
                                                 cost, ctx=ctx)))
    # Deterministic pick: predicted cost, then registry order (stable sort
    # keeps the enumeration order for ties).
    scores.sort(key=lambda s: s.predicted_us)
    best = scores[0]
    return AutoChoice(pipeline=best.pipeline, cfg=best.cfg,
                      predicted_us=best.predicted_us, features=feats,
                      scores=tuple(scores))


def select(plan: Optional[RoutingPlan], cfg: ScheduleConfig,
           cost_model: Optional[CostModel] = None, *,
           direction: str = "forward",
           allow_retile: bool = True) -> AutoChoice:
    """Full selector output (choice + per-candidate score table).

    ``plan`` overrides ``cfg``'s routing when given (the dropless path holds
    plans, not configs). ``cost_model`` defaults to the compile-time
    ``l2=False`` model the passes themselves use; a supplied model is
    normalized to ``l2=False`` (no execution order exists yet, so there is
    no residency to price).
    """
    if plan is not None and plan != cfg.routing:
        cfg = dataclasses.replace(cfg, plan=plan)
    cost = cost_model if cost_model is not None else CostModel(l2=False)
    if cost.l2:
        cost = dataclasses.replace(cost, l2=False)
    if direction not in ("forward", "backward"):
        raise ValueError(f"unknown direction {direction!r}")
    return _select(cfg, direction, allow_retile, cost)


def auto_pipeline(plan: Optional[RoutingPlan], cfg: ScheduleConfig,
                  cost_model: Optional[CostModel] = None, *,
                  direction: str = "forward",
                  allow_retile: bool = True,
                  ) -> tuple[Pipeline, ScheduleConfig]:
    """Resolve ``pipeline="auto"``: the predicted-best (Pipeline, config).

    Deterministic for equal plans, memoized on the hashable config.
    ``allow_retile=False`` pins the tiling (used by ``compile_schedule``,
    whose ODG task set is already built); the SSC cache resolves with the
    full budget grid.
    """
    choice = select(plan, cfg, cost_model, direction=direction,
                    allow_retile=allow_retile)
    return choice.pipeline, choice.cfg


@functools.lru_cache(maxsize=4096)
def _plan_us(cfg: ScheduleConfig, direction: str, names: tuple,
             cost: CostModel) -> float:
    return predict_makespan_us(cfg, direction, names, cost)


def predict_plan_us(plan: RoutingPlan, d_model: int, d_ff: int, *,
                    direction: str = "forward", pipeline=("ratr",),
                    cost: Optional[CostModel] = None,
                    dtype_bytes: int = 2) -> float:
    """Price one routing plan's step makespan — no compile, no selector grid.

    The admission-control and batch-sizing entry point
    (``launch/online.py``): a single :func:`predict_makespan_us` call at a
    fixed pipeline, memoized on the plan's count matrix, cheap enough to sit
    on the per-request serve path (the full :func:`select` grid prices every
    candidate and is reserved for refit-time re-pricing). Same units and
    same undershoot caveat as :func:`predict_makespan_us` — gate thresholds
    (SLOs) must be expressed against this predictor, not wall clock.
    """
    cost = cost if cost is not None else CostModel(l2=False)
    if cost.l2:
        cost = dataclasses.replace(cost, l2=False)
    cfg = ScheduleConfig(ep=plan.ep, e_loc=plan.e_loc, rows=0,
                         d_model=d_model, d_ff=d_ff, dtype_bytes=dtype_bytes,
                         gmm_split_mode="source_aligned", plan=plan)
    return _plan_us(cfg, direction, tuple(pipeline), cost)


# ---------------------------------------------------------------------------
# Multi-fragment selection — fused-vs-per-layer (cross-layer fusion) and
# fused-vs-per-stage (pipeline-parallel fusion). Both reuse the per-layer
# selector verbatim for the intra-fragment terms and only price what fusion
# changes: how fragments are *joined*.
# ---------------------------------------------------------------------------

def _boundary_remap_us(up_cfg: ScheduleConfig, dn_cfg: ScheduleConfig,
                       cost: CostModel) -> float:
    """One junction's in-taskflow LayerBoundary cost: the slowest rank's
    remap stream (upstream return read + downstream send write) spread over
    its AIV pool — the same bytes the boundary tiles carry."""
    hw = cost.hw
    b_in = up_cfg.d_model * up_cfg.dtype_bytes
    b_out = dn_cfg.d_model * dn_cfg.dtype_bytes
    per = [dn_cfg.routing.send_rows(r) * (b_in + b_out)
           / (hw.aiv_gbps * 1e3) for r in range(dn_cfg.ep)]
    return (max(per) if per else 0.0) / max(1, hw.num_aiv)


def _host_bridge_us(up_cfg: ScheduleConfig, dn_cfg: ScheduleConfig,
                    cost: CostModel) -> float:
    """One junction's per-layer alternative: drain to host between layers.

    The unfused path pays a host synchronization (the launch gap between
    layer N's combine and layer N+1's dispatch — same constant the
    baseline simulator charges per collective) plus two streaming passes
    over the token activations at HBM bandwidth: the upstream
    combine-weighted gather, then the downstream dispatch scatter."""
    hw = cost.hw
    b_in = up_cfg.d_model * up_cfg.dtype_bytes
    b_out = dn_cfg.d_model * dn_cfg.dtype_bytes
    per = [2 * (up_cfg.routing.send_rows(r) * b_in
                + dn_cfg.routing.send_rows(r) * b_out)
           / (hw.hbm_gbps * 1e3) for r in range(dn_cfg.ep)]
    return hw.collective_host_us + (max(per) if per else 0.0)


def _stage_link_us(up_cfg: ScheduleConfig, dn_cfg: ScheduleConfig,
                   cost: CostModel) -> float:
    """One microbatch's StageBoundary handoff at a junction: the slowest
    rank's activation payload over the stage link — the same per-link-class
    formula :meth:`CostModel.task_us` prices a StageBoundary tile with."""
    hw = cost.hw
    row_b = dn_cfg.d_model * dn_cfg.dtype_bytes
    topo = cost.topology if cost.topology is not None else dn_cfg.topology
    if topo is not None:
        lat, bw = topo.latency_us("inter"), topo.bw_gbps("inter") * 1e3
    else:
        lat, bw = hw.hop_latency_us, hw.link_gbps * 1e3
    per = [lat + dn_cfg.routing.send_rows(r) * row_b / bw
           for r in range(dn_cfg.ep)]
    return max(per) if per else 0.0


def _stage_decomp(cfg: ScheduleConfig, direction: str,
                  cost: CostModel) -> tuple[float, float]:
    """(compute-bound, comm-bound) per-stage slot times — the two resources
    a fused steady-state cell can hide behind each other."""
    hw = cost.hw
    plan = cfg.routing
    cube = cost.rank_cube_us(cube_taskset(plan, cfg, direction))
    link, vec = _comm_vec_us(plan, cfg, direction, cost)
    if cfg.topology is not None:
        link = _comm_topo_us(plan, cfg, cost)
    comp = max((max(cube[r] / hw.num_aic, vec[r] / hw.num_aiv)
                for r in range(plan.ep)), default=0.0)
    comm = float(np.max(link)) if np.size(link) else 0.0
    return comp, comm


@dataclasses.dataclass(frozen=True)
class FusedChoice:
    """Fused-vs-per-layer verdict for a layer stack (satellite of PR 6's
    ROADMAP leftover): both sides share the per-layer selector's best
    intra-layer estimates and differ only in the junction cost — the
    in-taskflow boundary remap vs the host round-trip."""

    fuse: bool
    predicted_fused_us: float
    predicted_per_layer_us: float
    choices: tuple[AutoChoice, ...]      # per layer, layer order


@functools.lru_cache(maxsize=256)
def _select_fused(cfgs: tuple, direction: str, allow_retile: bool,
                  cost: CostModel) -> FusedChoice:
    choices = tuple(_select(c, direction, allow_retile, cost) for c in cfgs)
    intra = sum(ch.predicted_us for ch in choices)
    juncs = list(zip(cfgs[:-1], cfgs[1:]))
    if direction == "backward":          # gradients flow top layer down
        juncs = [(dn, up) for (up, dn) in juncs]
    fused = intra + sum(_boundary_remap_us(u, d, cost) for u, d in juncs)
    per_layer = intra + sum(_host_bridge_us(u, d, cost) for u, d in juncs)
    return FusedChoice(fuse=fused <= per_layer, predicted_fused_us=fused,
                       predicted_per_layer_us=per_layer, choices=choices)


def select_fused(cfgs, *, direction: str = "forward",
                 cost_model: Optional[CostModel] = None,
                 allow_retile: bool = True) -> FusedChoice:
    """Price fused-vs-per-layer for a stack of layer configs (layer order),
    so ``pipeline="auto"`` / ``fuse="auto"`` can choose per batch."""
    cost = cost_model if cost_model is not None else CostModel(l2=False)
    if cost.l2:
        cost = dataclasses.replace(cost, l2=False)
    if direction not in ("forward", "backward"):
        raise ValueError(f"unknown direction {direction!r}")
    return _select_fused(tuple(cfgs), direction, allow_retile, cost)


@dataclasses.dataclass(frozen=True)
class PPChoice:
    """PP fused-vs-per-stage verdict.

    Both estimates share the fill/drain ramp (every stage runs microbatch
    0 in sequence, boundary handoffs included) and differ in the
    steady-state slot: the per-stage reference pays the bottleneck stage's
    *serial* (intra-stage estimate + incoming handoff) per microbatch,
    while the fused schedule hides comm behind compute within a slot —
    ``max(compute, comm + handoff)`` — clamped at the per-stage slot, so
    the fused estimate is never worse by construction (overlap can only
    remove waiting, never add work; the gate asserts this stays true).
    """

    fuse: bool
    n_stages: int
    n_microbatches: int
    predicted_fused_us: float
    predicted_per_stage_us: float
    bubble_us: float                     # (S-1) x bottleneck compute slot
    choices: tuple[AutoChoice, ...]      # per stage, stage order


@functools.lru_cache(maxsize=256)
def _select_pp(cfgs: tuple, n_microbatches: int, direction: str,
               allow_retile: bool, cost: CostModel) -> PPChoice:
    S, M = len(cfgs), n_microbatches
    choices = tuple(_select(c, direction, allow_retile, cost) for c in cfgs)
    pred = [ch.predicted_us for ch in choices]
    decomp = [_stage_decomp(ch.cfg, direction, cost) for ch in choices]
    # Incoming handoff per stage in this direction's dataflow: forward
    # stage s receives from s-1, backward from s+1.
    bnd_in = [0.0] * S
    if direction == "forward":
        for s in range(1, S):
            bnd_in[s] = _stage_link_us(cfgs[s - 1], cfgs[s], cost)
    else:
        for s in range(S - 1):
            bnd_in[s] = _stage_link_us(cfgs[s + 1], cfgs[s], cost)
    fill = sum(pred) + sum(bnd_in)
    per_slot = max(pred[s] + bnd_in[s] for s in range(S))
    fused_slot = max(min(max(decomp[s][0], decomp[s][1] + bnd_in[s]),
                         pred[s] + bnd_in[s]) for s in range(S))
    per_stage = fill + (M - 1) * per_slot
    fused = fill + (M - 1) * fused_slot
    bubble = (S - 1) * max(d[0] for d in decomp)
    return PPChoice(fuse=fused <= per_stage, n_stages=S, n_microbatches=M,
                    predicted_fused_us=fused,
                    predicted_per_stage_us=per_stage,
                    bubble_us=bubble, choices=choices)


def select_pp(cfgs, n_microbatches: int, *, direction: str = "forward",
              cost_model: Optional[CostModel] = None,
              allow_retile: bool = True) -> PPChoice:
    """Price PP fused-vs-per-stage for per-stage configs (stage order).

    This is how ``pipeline="auto"`` picks the winner per plan tuple before
    committing to ``compile_pp_fused``: the per-stage intra estimates come
    from the same memoized :func:`select` grid the unfused path resolves
    with, so a fused pick never contradicts the per-stage picks it is
    built from.
    """
    if n_microbatches < 1:
        raise ValueError(f"n_microbatches must be >= 1, "
                         f"got {n_microbatches}")
    cost = cost_model if cost_model is not None else CostModel(l2=False)
    if cost.l2:
        cost = dataclasses.replace(cost, l2=False)
    if direction not in ("forward", "backward"):
        raise ValueError(f"unknown direction {direction!r}")
    return _select_pp(tuple(cfgs), int(n_microbatches), direction,
                      allow_retile, cost)


def is_auto(pipeline) -> bool:
    """True when ``pipeline`` is the literal auto-selection request."""
    return isinstance(pipeline, str) and pipeline == AUTO


def selection_cache_info():
    """Memoization stats for the selector (monitoring / benchmarks)."""
    return _select.cache_info()


def selection_cache_clear() -> None:
    _select.cache_clear()
