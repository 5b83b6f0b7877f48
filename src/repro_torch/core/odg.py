"""Operator Dependency Graph (ODG) — HyperParallel-MoE's scheduling IR (§4.2).

The ODG describes the operator-level dataflow of a schedulable MoE-FFN
fragment. Nodes are :class:`OperatorNode`s; edges are tensor dependencies
expressed through shared :class:`TensorRef` objects. Each node carries a
:class:`SplitSpec` describing its *legal* tiling strategy:

* ``split_inputs`` — which input tensors must already carry a compatible
  partition (``None`` marks a partitioning *origin*, e.g. Dispatch);
* ``split_output_dims`` — along which dimension each output's partition
  keeps propagating downstream (``-1`` = stop propagating);
* ``task_num_fn`` — how many tile tasks to generate for a given shape /
  parallel configuration (plan-aware: counts come from the nonzero cells of
  the operator's :class:`~repro_torch.core.routing.RoutingPlan`, not a fixed grid).

``build_moe_ffn_forward`` / ``build_moe_ffn_backward`` construct the exact
graphs of Fig. 2(a)/(b) for one EP group. Tensor extents are driven by
``ScheduleConfig.routing`` — a :class:`RoutingPlan` whose per-(src, dst,
expert) row counts may be arbitrarily imbalanced (skewed, sparse, hotspot);
the balanced plan reproduces the paper's controlled Table-3 setting and the
seed's schedules exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

from .hardware import Topology
from .routing import HierDispatch, RoutingPlan, balanced_plan

# Resource classes (paper: AIC = cube/matrix, AIV = vector/comm/data-movement).
CUBE = "cube"
VECTOR = "vector"

# Queue names.
CTQ = "CTQ"
VTQ = "VTQ"

RESOURCE_TO_QUEUE = {CUBE: CTQ, VECTOR: VTQ}


@dataclasses.dataclass
class TensorRef:
    """A logical tensor in the ODG.

    ``rows``/``row_bytes`` define the canonical *row layout* used for tile
    range bookkeeping: every tile task reads/writes a contiguous row range of
    some tensor. ``split_dim``/``split_num`` are the partition labels written
    and consumed by split propagation (Algorithm 1); by convention the row
    dimension is dim 0, so a row-partitioned tensor has ``split_dim == 0``.
    """

    name: str
    rows: int
    row_bytes: int
    dtype: str = "bf16"
    # Partition labels (mutated by split propagation).
    split_dim: int = -1
    split_num: int = 1
    # True for tensors produced outside this fragment (weights, saved acts).
    external: bool = False

    @property
    def nbytes(self) -> int:
        return self.rows * self.row_bytes


@dataclasses.dataclass(frozen=True)
class SplitSpec:
    """Legal tiling strategy for one operator (§4.2)."""

    # ((input_index, required_split_dim), ...) or None for partition origins.
    split_inputs: Optional[tuple[tuple[int, int], ...]]
    # Per output: dimension along which the partition propagates (-1 = stop).
    split_output_dims: tuple[int, ...]
    # (config, operator) → number of tile tasks; plan-aware fns use the
    # operator's rank to count its nonzero routing cells.
    task_num_fn: Callable[["ScheduleConfig", "OperatorNode"], int]
    # Input indices excluded from split checking (e.g. Combine's offset/size
    # metadata tensors — paper §4.2 example).
    ignore_inputs: tuple[int, ...] = ()
    # Label outputs row-partitioned even when this op emits ≤1 tasks. Set
    # for Dispatch: its *receive* buffer is written in exact per-cell ranges
    # by every source rank's tasks, so downstream tiling is legal no matter
    # how few cells this particular sender has (hotspot / zero-send ranks).
    always_label: bool = False


@dataclasses.dataclass
class OperatorNode:
    """One operator instance in the ODG (per EP rank for rank-local ops)."""

    name: str
    op_type: str                 # dispatch | gmm | swiglu | combine | ...
    resource: str                # CUBE or VECTOR
    rank: int                    # EP rank that *executes* this operator
    inputs: list[TensorRef]
    outputs: list[TensorRef]
    split_spec: SplitSpec
    meta: dict = dataclasses.field(default_factory=dict)
    # Filled in by split propagation.
    task_num: int = 1

    @property
    def queue(self) -> str:
        return RESOURCE_TO_QUEUE[self.resource]


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    """Shape + parallel configuration C handed to split propagation.

    ``rows`` describes the balanced-routing special case (the controlled
    setting of the paper's Table 3): every (src rank, dst rank, local expert)
    triple carries the same token count. Supplying ``plan`` instead drives
    the whole stack from a per-cell :class:`RoutingPlan` — imbalanced,
    sparse, or hotspot routing as produced by a real router (see
    ``models.moe.plan_from_routing``). ``d_model``/``d_ff`` in elements;
    dtype_bytes for bf16=2.
    """

    ep: int                      # EP group size
    e_loc: int                   # local experts per rank
    rows: int                    # tokens per (src, dst, expert) triple
    d_model: int
    d_ff: int
    dtype_bytes: int = 2
    # Extra row-wise splits per expert GMM tile (1 = one tile per expert,
    # the paper's "tile covers a complete expert width" default). Under a
    # plan, each expert block is cut into ≤ gmm_m_split ragged chunks.
    gmm_m_split: int = 1
    # How gmm_m_split chunk boundaries are placed inside an expert block:
    # "even" (seed behaviour — equal chunks, only legal when boundaries
    # happen to align with dispatch cells) or "source_aligned" (boundaries
    # restricted to source-cell edges, legal for arbitrary imbalanced
    # plans). See RoutingPlan.gmm_tiles.
    gmm_split_mode: str = "even"
    # Imbalanced routing plan; None means the balanced grid from ``rows``.
    plan: Optional[RoutingPlan] = None
    # Quantization provenance of ``plan``: the canonical key tuple of the
    # repro_torch.core.buckets.BucketSpec the plan's counts were quantized with
    # (None = unbucketed/exact). Part of the SSC cache key, so schedules
    # compiled under different bucket policies never alias even when two
    # policies happen to map one batch to the same counts; recorded in
    # Schedule.opts / the SSC blob for provenance. Any BucketSpec /
    # int / str / spec form normalizes to the key tuple at construction.
    bucket: Optional[tuple] = None
    # Cluster link topology (core/hardware.Topology). None = every link
    # equal (the flat-interconnect assumption of the seed). Setting it
    # makes link classes visible to the cost model, autoselect, and the
    # node-aware passes even when dispatch stays flat.
    topology: Optional[Topology] = None
    # "flat" — one put per nonzero (dst, expert) cell (seed behaviour);
    # "hier" — two-level dispatch: same-node cells stay flat, cross-node
    # cells are gathered at a node-leader rank and take the inter-node
    # hop as one aggregated message per (leader, dst, expert) group.
    # Requires ``topology`` and ``gmm_split_mode="source_aligned"``.
    dispatch_mode: str = "flat"
    # Compress the aggregated inter-node hop only: None or "int8"
    # (symmetric per-message quantization; see parallel/compression.py).
    xnode_compress: Optional[str] = None

    def __post_init__(self):
        if self.gmm_split_mode not in ("even", "source_aligned"):
            raise ValueError(
                f"gmm_split_mode must be 'even' or 'source_aligned', "
                f"got {self.gmm_split_mode!r}")
        if self.bucket is not None:
            from .buckets import BucketSpec
            object.__setattr__(self, "bucket",
                               BucketSpec.from_any(self.bucket).key())
        if self.plan is not None and (self.plan.ep != self.ep
                                      or self.plan.e_loc != self.e_loc):
            raise ValueError(
                f"plan shape ({self.plan.ep}, {self.plan.e_loc}) does not "
                f"match config (ep={self.ep}, e_loc={self.e_loc})")
        if self.dispatch_mode not in ("flat", "hier"):
            raise ValueError(
                f"dispatch_mode must be 'flat' or 'hier', "
                f"got {self.dispatch_mode!r}")
        if self.xnode_compress not in (None, "int8"):
            raise ValueError(
                f"xnode_compress must be None or 'int8', "
                f"got {self.xnode_compress!r}")
        if self.topology is not None and self.ep % self.topology.ranks_per_node:
            raise ValueError(
                f"ep={self.ep} is not a multiple of "
                f"topology.ranks_per_node={self.topology.ranks_per_node}")
        if self.dispatch_mode == "hier":
            if self.topology is None:
                raise ValueError("dispatch_mode='hier' requires a topology")
            if self.gmm_split_mode != "source_aligned":
                raise ValueError(
                    "dispatch_mode='hier' requires "
                    "gmm_split_mode='source_aligned' (tile boundaries must "
                    "respect aggregated inter-node message atoms)")
        if self.xnode_compress is not None and self.dispatch_mode != "hier":
            raise ValueError(
                "xnode_compress only applies to dispatch_mode='hier'")

    @property
    def hier(self) -> Optional[HierDispatch]:
        """Two-level dispatch geometry, or None under flat dispatch."""
        if self.dispatch_mode != "hier":
            return None
        return HierDispatch(self.routing, self.topology.ranks_per_node,
                            agg_rows=self.tile_agg_rows)

    @property
    def tile_atom_nodes(self) -> Optional[int]:
        """Node size for GMM/vector tile atoms (hier mode only): tiles may
        not split the landing zone of an aggregated inter-node message."""
        if self.dispatch_mode != "hier":
            return None
        return self.topology.ranks_per_node

    @property
    def tile_agg_rows(self) -> Optional[float]:
        """Aggregation threshold in rows (hier mode only): the row count
        whose inter-node transfer time equals one inter-node hop latency.
        A remote-node group aggregates iff its total rows stay within
        ``(n_cells - 1)`` times this — the hop latency saved covers the
        per-cell pipelining given up (see ``routing.aggregate_group``)."""
        if self.dispatch_mode != "hier":
            return None
        t = self.topology
        return (t.inter_hop_us * t.inter_gbps * 1e3
                / (self.d_model * self.dtype_bytes))

    @property
    def routing(self) -> RoutingPlan:
        """The routing plan driving all extents (balanced if none given)."""
        if self.plan is not None:
            return self.plan
        return balanced_plan(self.ep, self.e_loc, self.rows)

    @property
    def rows_per_expert(self) -> int:
        """Balanced-grid rows per local expert (from all ep source ranks).

        Only meaningful without a plan; plan-aware code paths use
        ``routing.expert_rows(rank, e)`` instead.
        """
        return self.ep * self.rows

    @property
    def recv_rows(self) -> int:
        """Balanced-grid rows in a rank's dispatch-receive buffer."""
        return self.e_loc * self.rows_per_expert


class ODG:
    """A directed acyclic operator graph over one EP group."""

    def __init__(self, cfg: ScheduleConfig, direction: str):
        self.cfg = cfg
        self.direction = direction          # "forward" | "backward"
        self.tensors: dict[str, TensorRef] = {}
        self.ops: list[OperatorNode] = []

    # -- construction -----------------------------------------------------
    def tensor(self, name: str, rows: int, row_bytes: int, **kw) -> TensorRef:
        if name in self.tensors:
            return self.tensors[name]
        t = TensorRef(name=name, rows=rows, row_bytes=row_bytes, **kw)
        self.tensors[name] = t
        return t

    def add_op(self, op: OperatorNode) -> OperatorNode:
        self.ops.append(op)
        return op

    # -- queries -----------------------------------------------------------
    def topological(self) -> list[OperatorNode]:
        """Ops in topological order.

        Construction order is already topological for the builders below, but
        we verify: every non-external input must have been produced by an
        earlier op (or be external).
        """
        produced: set[str] = set()
        for op in self.ops:
            for t in op.inputs:
                if not t.external and t.name not in produced:
                    raise ValueError(
                        f"ODG not topologically ordered: {op.name} reads "
                        f"{t.name} before it is produced")
            for t in op.outputs:
                produced.add(t.name)
        return list(self.ops)

    def validate_acyclic(self) -> None:
        self.topological()


# ---------------------------------------------------------------------------
# SplitSpecs for the MoE-FFN operators (paper §4.2).
# ---------------------------------------------------------------------------

def _dispatch_tasks(c: ScheduleConfig, op: "OperatorNode") -> int:
    # One put_mem_signal task per *nonzero* (dst rank, local expert) cell of
    # this source rank's plan (balanced: ep * e_loc).
    return c.routing.n_send_cells(op.rank)


def _dispatch_x_tasks(c: ScheduleConfig, op: "OperatorNode") -> int:
    # One aggregated inter-node put per (leader, dst rank, expert) group
    # homed at this leader rank (hier dispatch only).
    return c.hier.n_stage_groups(op.rank)


def _gmm_tasks(c: ScheduleConfig, op: "OperatorNode") -> int:
    # Task-level parallelism only along expert blocks (× optional row split);
    # the K reduction dimension stays intact (§4.2). Empty experts produce
    # no tiles; ragged blocks produce a ragged last chunk.
    return c.routing.n_gmm_tiles(op.rank, c.gmm_m_split, c.gmm_split_mode,
                                 c.tile_atom_nodes, c.tile_agg_rows)


def _vector_tasks(c: ScheduleConfig, op: "OperatorNode") -> int:
    # AIV-side elementwise ops align with GMM row partitions.
    return c.routing.n_gmm_tiles(op.rank, c.gmm_m_split, c.gmm_split_mode,
                                 c.tile_atom_nodes, c.tile_agg_rows)


def _combine_tasks(c: ScheduleConfig, op: "OperatorNode") -> int:
    # One put_mem_signal task per nonzero (source rank, local expert) cell
    # returned by this rank (balanced: ep * e_loc).
    return c.routing.n_combine_cells(op.rank)


DISPATCH_SPEC = SplitSpec(split_inputs=None, split_output_dims=(0,),
                          task_num_fn=_dispatch_tasks, always_label=True)
# Hier dispatch declares the staging buffer as a second output.
HIER_DISPATCH_SPEC = SplitSpec(split_inputs=None, split_output_dims=(0, 0),
                               task_num_fn=_dispatch_tasks, always_label=True)
# The aggregated inter-node hop is its own partitioning origin: one task
# per (leader, dst, expert) staging group.
DISPATCH_X_SPEC = SplitSpec(split_inputs=None, split_output_dims=(0,),
                            task_num_fn=_dispatch_x_tasks, always_label=True)
GMM_SPEC = SplitSpec(split_inputs=((0, 0),), split_output_dims=(0,),
                     task_num_fn=_gmm_tasks)
SWIGLU_SPEC = SplitSpec(split_inputs=((0, 0),), split_output_dims=(0,),
                        task_num_fn=_vector_tasks)
# Combine inherits row partitioning from its *data* input (input 0) and
# ignores routing-metadata inputs during split checking (§4.2).
COMBINE_SPEC = SplitSpec(split_inputs=((0, 0),), split_output_dims=(0,),
                         task_num_fn=_combine_tasks, ignore_inputs=(1,))
# Weight-gradient GMMs terminate propagation (outputs are weight blocks).
GMM_WGRAD_SPEC = SplitSpec(split_inputs=((0, 0),), split_output_dims=(-1,),
                           task_num_fn=_gmm_tasks)


# ---------------------------------------------------------------------------
# Graph builders — Fig. 2(a) forward and Fig. 2(b) backward.
# ---------------------------------------------------------------------------

def build_moe_ffn_forward(cfg: ScheduleConfig) -> ODG:
    """Dispatch → GMM1 → SwiGLU → GMM2 → Combine, per EP rank."""
    g = ODG(cfg, "forward")
    db = cfg.dtype_bytes
    d, f = cfg.d_model, cfg.d_ff
    plan = cfg.routing

    hier = cfg.hier
    for r in range(cfg.ep):
        # Source-side routed tokens, grouped by (dst rank, expert).
        x_src = g.tensor(f"x_src@{r}", plan.send_rows(r), d * db,
                         external=True)
        # Receive buffer, grouped by (expert, src rank) — expert-major so each
        # expert's rows are contiguous for the GMM.
        x_recv = g.tensor(f"x_recv@{r}", plan.recv_rows(r), d * db)
        outputs, spec = [x_recv], DISPATCH_SPEC
        if hier is not None:
            # Node-leader staging buffer for this rank's homed groups.
            outputs.append(g.tensor(f"x_recv_stg@{r}", hier.stage_rows(r),
                                    d * db))
            spec = HIER_DISPATCH_SPEC
        g.add_op(OperatorNode(
            name=f"Dispatch@{r}", op_type="dispatch", resource=VECTOR, rank=r,
            inputs=[x_src], outputs=outputs, split_spec=spec))

    if hier is not None:
        for r in range(cfg.ep):
            if hier.n_stage_groups(r) == 0:
                continue
            g.add_op(OperatorNode(
                name=f"DispatchX@{r}", op_type="dispatch_xnode",
                resource=VECTOR, rank=r,
                inputs=[g.tensors[f"x_recv_stg@{r}"]],
                outputs=[g.tensors[f"x_recv@{r}"]],
                split_spec=DISPATCH_X_SPEC))

    for r in range(cfg.ep):
        x_recv = g.tensors[f"x_recv@{r}"]
        w1 = g.tensor(f"W1@{r}", cfg.e_loc, d * 2 * f * db, external=True)
        h = g.tensor(f"h@{r}", plan.recv_rows(r), 2 * f * db)
        g.add_op(OperatorNode(
            name=f"GMM1@{r}", op_type="gmm", resource=CUBE, rank=r,
            inputs=[x_recv, w1], outputs=[h], split_spec=GMM_SPEC,
            meta={"which": "gmm1"}))

        act = g.tensor(f"g@{r}", plan.recv_rows(r), f * db)
        g.add_op(OperatorNode(
            name=f"SwiGLU@{r}", op_type="swiglu", resource=VECTOR, rank=r,
            inputs=[h], outputs=[act], split_spec=SWIGLU_SPEC,
            meta={"plan_tiling": "expert"}))

        w2 = g.tensor(f"W2@{r}", cfg.e_loc, f * d * db, external=True)
        y = g.tensor(f"y@{r}", plan.recv_rows(r), d * db)
        g.add_op(OperatorNode(
            name=f"GMM2@{r}", op_type="gmm", resource=CUBE, rank=r,
            inputs=[act, w2], outputs=[y], split_spec=GMM_SPEC,
            meta={"which": "gmm2"}))

    for r in range(cfg.ep):
        y = g.tensors[f"y@{r}"]
        meta_t = g.tensor(f"route_meta@{r}", cfg.ep * cfg.e_loc, 8,
                          external=True)
        y_ret = g.tensor(f"y_ret@{r}", plan.send_rows(r), d * db)
        g.add_op(OperatorNode(
            name=f"Combine@{r}", op_type="combine", resource=VECTOR, rank=r,
            inputs=[y, meta_t], outputs=[y_ret], split_spec=COMBINE_SPEC))

    g.validate_acyclic()
    return g


def build_moe_ffn_backward(cfg: ScheduleConfig) -> ODG:
    """The 7-node backward graph of Fig. 2(b).

    DispatchB → {GMM_act_grad, GMM_w2_grad} → SwiGLU_grad →
    {GMM_gate_grad, GMM_w1_grad} → CombineB.
    ``GMM_act_grad``/``GMM_w2_grad`` independently consume the dispatched
    upstream gradient; ``GMM_gate_grad``/``GMM_w1_grad`` independently consume
    the SwiGLU gradient — the freedom exploited by cache-guided interleaving.
    """
    g = ODG(cfg, "backward")
    db = cfg.dtype_bytes
    d, f = cfg.d_model, cfg.d_ff
    plan = cfg.routing

    hier = cfg.hier
    for r in range(cfg.ep):
        dy_src = g.tensor(f"dy_src@{r}", plan.send_rows(r),
                          d * db, external=True)
        dy_recv = g.tensor(f"dy_recv@{r}", plan.recv_rows(r), d * db)
        outputs, spec = [dy_recv], DISPATCH_SPEC
        if hier is not None:
            outputs.append(g.tensor(f"dy_recv_stg@{r}", hier.stage_rows(r),
                                    d * db))
            spec = HIER_DISPATCH_SPEC
        g.add_op(OperatorNode(
            name=f"DispatchB@{r}", op_type="dispatch", resource=VECTOR,
            rank=r, inputs=[dy_src], outputs=outputs,
            split_spec=spec))

    if hier is not None:
        for r in range(cfg.ep):
            if hier.n_stage_groups(r) == 0:
                continue
            g.add_op(OperatorNode(
                name=f"DispatchBX@{r}", op_type="dispatch_xnode",
                resource=VECTOR, rank=r,
                inputs=[g.tensors[f"dy_recv_stg@{r}"]],
                outputs=[g.tensors[f"dy_recv@{r}"]],
                split_spec=DISPATCH_X_SPEC))

    for r in range(cfg.ep):
        dy_recv = g.tensors[f"dy_recv@{r}"]
        w2 = g.tensor(f"W2@{r}", cfg.e_loc, f * d * db, external=True)
        g_saved = g.tensor(f"g_saved@{r}", plan.recv_rows(r), f * db,
                           external=True)
        dg = g.tensor(f"dg@{r}", plan.recv_rows(r), f * db)
        g.add_op(OperatorNode(
            name=f"GMM_act_grad@{r}", op_type="gmm", resource=CUBE, rank=r,
            inputs=[dy_recv, w2], outputs=[dg], split_spec=GMM_SPEC,
            meta={"which": "act_grad", "branch": "dy"}))
        dW2 = g.tensor(f"dW2@{r}", cfg.e_loc, f * d * 4)  # fp32 wgrad
        g.add_op(OperatorNode(
            name=f"GMM_w2_grad@{r}", op_type="gmm_wgrad", resource=CUBE,
            rank=r, inputs=[dy_recv, g_saved], outputs=[dW2],
            split_spec=GMM_WGRAD_SPEC,
            meta={"which": "w2_grad", "branch": "dy"}))

        h_saved = g.tensor(f"h_saved@{r}", plan.recv_rows(r), 2 * f * db,
                           external=True)
        dh = g.tensor(f"dh@{r}", plan.recv_rows(r), 2 * f * db)
        g.add_op(OperatorNode(
            name=f"SwiGLU_grad@{r}", op_type="swiglu_grad", resource=VECTOR,
            rank=r, inputs=[dg, h_saved], outputs=[dh],
            split_spec=SWIGLU_SPEC, meta={"plan_tiling": "expert"}))

        w1 = g.tensor(f"W1@{r}", cfg.e_loc, d * 2 * f * db, external=True)
        dx_disp = g.tensor(f"dx_disp@{r}", plan.recv_rows(r), d * db)
        g.add_op(OperatorNode(
            name=f"GMM_gate_grad@{r}", op_type="gmm", resource=CUBE, rank=r,
            inputs=[dh, w1], outputs=[dx_disp], split_spec=GMM_SPEC,
            meta={"which": "gate_grad", "branch": "dh"}))
        x_saved = g.tensor(f"x_recv_saved@{r}", plan.recv_rows(r), d * db,
                           external=True)
        dW1 = g.tensor(f"dW1@{r}", cfg.e_loc, d * 2 * f * 4)
        g.add_op(OperatorNode(
            name=f"GMM_w1_grad@{r}", op_type="gmm_wgrad", resource=CUBE,
            rank=r, inputs=[dh, x_saved], outputs=[dW1],
            split_spec=GMM_WGRAD_SPEC,
            meta={"which": "w1_grad", "branch": "dh"}))

    for r in range(cfg.ep):
        dx_disp = g.tensors[f"dx_disp@{r}"]
        meta_t = g.tensor(f"route_meta@{r}", cfg.ep * cfg.e_loc, 8,
                          external=True)
        dx_ret = g.tensor(f"dx_ret@{r}", plan.send_rows(r), d * db)
        g.add_op(OperatorNode(
            name=f"CombineB@{r}", op_type="combine", resource=VECTOR, rank=r,
            inputs=[dx_disp, meta_t], outputs=[dx_ret],
            split_spec=COMBINE_SPEC))

    g.validate_acyclic()
    return g
