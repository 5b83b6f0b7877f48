"""Tile Task Descriptors (TDs) and per-operator FillConfigs (§4.2, Table 1).

A TD is the basic runtime-consumed unit. ``FillConfig`` functions transform
an operator's legal tile tasks (count decided by split propagation) into
runtime-consumable TDs: tile row ranges, queue type, comm endpoints, and the
read/write sets used by the static scheduler for dependency derivation.

Read/write sets use the canonical *(tensor, rank, row range)* addressing of
``odg.TensorRef`` — an interval-overlap between a writer and a reader is a
true data dependency. Cross-rank communication tasks are sender-side tasks
(the AIV worker that issues ``put_mem_signal``) whose *writes* land on the
destination rank, mirroring one-sided remote-write semantics.

All tile extents are *plan-driven*: offsets and row counts come from the
config's :class:`~repro_torch.core.routing.RoutingPlan`, so cells of an imbalanced
plan produce variable-extent tiles with exact read/write ranges, empty cells
produce no tasks at all, and non-divisible row counts produce a ragged last
tile instead of silently dropping remainder rows. The balanced plan emits
byte-identical TDs to the seed's fixed-grid arithmetic.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .odg import ODG, OperatorNode, ScheduleConfig, CTQ, VTQ

# Sentinel event id meaning "no event" (paper uses uint32 fields).
NO_EVENT = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class Range:
    """A contiguous row range of (tensor, rank)."""

    tensor: str
    rank: int
    lo: int
    hi: int

    @property
    def rows(self) -> int:
        return self.hi - self.lo

    def overlaps(self, other: "Range") -> bool:
        return (self.tensor == other.tensor and self.rank == other.rank
                and self.lo < other.hi and other.lo < self.hi)


@dataclasses.dataclass
class TaskDescriptor:
    """Table 1 of the paper, plus the scheduler-facing read/write sets."""

    # --- Table 1 fields ---------------------------------------------------
    task_type: str               # GMM | SwiGLU | SwiGLUGrad | put_mem_signal…
    queue_type: str              # CTQ or VTQ
    dependent_event: int = NO_EVENT
    trigger_event: int = NO_EVENT
    inputs: list[Range] = dataclasses.field(default_factory=list)
    outputs: list[Range] = dataclasses.field(default_factory=list)
    task_index: int = 0
    task_split_num: int = 1
    task_split_value: int = 0    # rows per tile, used to derive tile ranges
    tiling_data_position: int = 0
    # --- framework metadata ------------------------------------------------
    op_name: str = ""
    op_type: str = ""
    rank: int = 0                # executing rank (sender side for comm)
    meta: dict = dataclasses.field(default_factory=dict)
    # Threshold the dependent event counter must reach (paper §4.3).
    dependent_threshold: int = 0
    # Globally unique id assigned by the scheduler.
    tid: int = -1

    # Cost model hooks (filled by FillConfig; consumed by the simulator).
    flops: float = 0.0
    read_bytes: float = 0.0
    write_bytes: float = 0.0
    comm_bytes: float = 0.0
    src_rank: int = -1
    dst_rank: int = -1


# ---------------------------------------------------------------------------
# FillConfig registry
# ---------------------------------------------------------------------------

_FILL_REGISTRY: dict[str, "callable"] = {}


def fill_config(op_type: str):
    def deco(fn):
        _FILL_REGISTRY[op_type] = fn
        return fn
    return deco


def fill_tasks(g: ODG, op: OperatorNode) -> list[TaskDescriptor]:
    fn = _FILL_REGISTRY.get(op.op_type)
    if fn is None:
        raise KeyError(f"no FillConfig registered for op_type={op.op_type}")
    tds = fn(g.cfg, op)
    # Ragged tiling may emit fewer tiles than propagation requested (e.g.
    # rows < task_num); sync the operator so task_num always matches the
    # emitted tile set.
    op.task_num = len(tds)
    for i, td in enumerate(tds):
        td.op_name = op.name
        td.op_type = op.op_type
        td.rank = op.rank
        td.task_index = i
        td.task_split_num = len(tds)
    return tds


def _db(cfg: ScheduleConfig) -> int:
    return cfg.dtype_bytes


# -- Dispatch / Combine: put_mem_signal communication tasks ------------------

@fill_config("dispatch")
def _fill_dispatch(cfg: ScheduleConfig, op: OperatorNode) -> list[TaskDescriptor]:
    """One put_mem_signal per nonzero (dst rank, local expert) plan cell.

    Source layout groups rows by (dst, expert); destination layout groups by
    (expert, src) so that each expert's rows are contiguous for the GMM.
    """
    plan = cfg.routing
    r = op.rank
    src_t, dst_t = op.inputs[0], op.outputs[0]
    row_b = src_t.row_bytes
    base_src = src_t.name.split("@")[0]
    base_dst = dst_t.name.split("@")[0]
    cells = plan.send_cells(r)               # (dst, e, count), dst-major
    if not cells:
        return []
    hier = cfg.hier
    base_stg = base_dst + "_stg"
    # Dispatch is a partitioning origin (split_inputs=None), so it never
    # falls back to one unsplit task: always one exact TD per nonzero cell.
    tds = []
    for (d, e, c) in cells:
        s_lo = plan.send_offset(r, d, e)
        if (hier is not None and not hier.same_node(r, d)
                and hier.aggregated(hier.node_of(r), d, e)):
            # Two-level dispatch, stage 1: gather this cell into the
            # (dst, expert) group's staging slot on the node leader —
            # an intra-node hop.
            leader = hier.leader(hier.node_of(r), d, e)
            g_lo = hier.cell_offset(leader, d, e, r)
            tds.append(TaskDescriptor(
                task_type="put_mem_signal", queue_type=VTQ,
                inputs=[Range(base_src, r, s_lo, s_lo + c)],
                outputs=[Range(base_stg, leader, g_lo, g_lo + c)],
                task_split_value=c,
                comm_bytes=c * row_b, src_rank=r, dst_rank=leader,
                read_bytes=c * row_b, write_bytes=c * row_b,
                meta={"expert": e, "dst": d, "comm_kind": "dispatch",
                      "stage": "gather", "dst_node": hier.node_of(d)}))
            continue
        d_lo = plan.recv_offset(d, e, r)
        tds.append(TaskDescriptor(
            task_type="put_mem_signal", queue_type=VTQ,
            inputs=[Range(base_src, r, s_lo, s_lo + c)],
            outputs=[Range(base_dst, d, d_lo, d_lo + c)],
            task_split_value=c,
            comm_bytes=c * row_b, src_rank=r, dst_rank=d,
            read_bytes=c * row_b, write_bytes=c * row_b,
            meta={"expert": e, "dst": d, "comm_kind": "dispatch"}))
    return tds


@fill_config("dispatch_xnode")
def _fill_dispatch_xnode(cfg: ScheduleConfig,
                         op: OperatorNode) -> list[TaskDescriptor]:
    """Two-level dispatch, stage 2: one aggregated inter-node put per
    (dst rank, expert) group staged at this node-leader rank.

    The staging buffer is (d, e)-major with sources ascending inside a
    group, and the destination recv buffer is (expert, src)-major — so one
    contiguous staging range lands in one contiguous recv range, row-for-row
    identical to what flat per-cell dispatch would have delivered.
    """
    from repro_torch.parallel.compression import int8_wire_bytes

    hier = cfg.hier
    leader = op.rank
    stg_t, dst_t = op.inputs[0], op.outputs[0]
    row_b = stg_t.row_bytes
    base_stg = stg_t.name.split("@")[0]
    base_dst = dst_t.name.split("@")[0]
    src_node = hier.node_of(leader)
    tds = []
    for (d, e, _srcs, total) in hier.stage_groups(leader):
        g_lo = hier.group_offset(leader, d, e)
        d_lo, rows = hier.recv_node_span(d, e, src_node)
        assert rows == total
        nbytes = total * row_b
        comm = nbytes
        meta = {"expert": e, "dst": d, "comm_kind": "dispatch",
                "stage": "xnode", "dst_node": hier.node_of(d)}
        if cfg.xnode_compress == "int8":
            comm = int8_wire_bytes(nbytes, cfg.dtype_bytes)
            meta["compress"] = "int8"
        tds.append(TaskDescriptor(
            task_type="put_mem_signal", queue_type=VTQ,
            inputs=[Range(base_stg, leader, g_lo, g_lo + total)],
            outputs=[Range(base_dst, d, d_lo, d_lo + total)],
            task_split_value=total,
            comm_bytes=comm, src_rank=leader, dst_rank=d,
            read_bytes=nbytes, write_bytes=nbytes,
            meta=meta))
    return tds


@fill_config("combine")
def _fill_combine(cfg: ScheduleConfig, op: OperatorNode) -> list[TaskDescriptor]:
    """One put_mem_signal per nonzero (source rank, local expert) cell."""
    plan = cfg.routing
    r = op.rank
    src_t, ret_t = op.inputs[0], op.outputs[0]
    row_b = src_t.row_bytes
    base_src = src_t.name.split("@")[0]
    base_ret = ret_t.name.split("@")[0]
    cells = plan.combine_cells(r)            # (src, e, count), src-major
    if not cells:
        return []
    if op.task_num == 1 and len(cells) > 1:
        # Fallback: outputs ordered to match the (e, src)-major input layout
        # so a sequential block copy is numerically correct.
        outs = [Range(base_ret, s, plan.send_offset(s, r, e),
                      plan.send_offset(s, r, e) + c)
                for (e, s, c) in plan.recv_layout_cells(r)]
        total = plan.recv_rows(r)
        return [TaskDescriptor(
            task_type="put_mem_signal", queue_type=VTQ,
            inputs=[Range(base_src, r, 0, total)],
            outputs=outs,
            task_split_value=total,
            comm_bytes=total * row_b, src_rank=r, dst_rank=-1,
            read_bytes=total * row_b, write_bytes=total * row_b,
            meta={"fallback": True, "comm_kind": "combine"})]
    tds = []
    for (s, e, c) in cells:
        y_lo = plan.recv_offset(r, e, s)     # expert-major on this rank
        ret_lo = plan.send_offset(s, r, e)   # (dst=r, expert) on source s
        tds.append(TaskDescriptor(
            task_type="put_mem_signal", queue_type=VTQ,
            inputs=[Range(base_src, r, y_lo, y_lo + c)],
            outputs=[Range(base_ret, s, ret_lo, ret_lo + c)],
            task_split_value=c,
            comm_bytes=c * row_b, src_rank=r, dst_rank=s,
            read_bytes=c * row_b, write_bytes=c * row_b,
            meta={"expert": e, "dst": s, "comm_kind": "combine"}))
    return tds


# -- GMM: expert-block tiles (full-K reduction) ------------------------------

def _gmm_tiles(cfg: ScheduleConfig, op: OperatorNode,
               task_type: str) -> list[TaskDescriptor]:
    plan = cfg.routing
    r = op.rank
    in_t, w_t = op.inputs[0], op.inputs[1]
    out_t = op.outputs[0]
    base_in = in_t.name.split("@")[0]
    base_w = w_t.name.split("@")[0]
    base_out = out_t.name.split("@")[0]
    in_row_b, out_row_b = in_t.row_bytes, out_t.row_bytes

    if op.task_num == 1:
        if in_t.rows == 0:
            return []
        k = in_row_b // _db(cfg)
        n = out_row_b // _db(cfg)
        return [TaskDescriptor(
            task_type=task_type, queue_type=CTQ,
            inputs=[Range(base_in, r, 0, in_t.rows),
                    Range(base_w, r, 0, w_t.rows)],
            outputs=[Range(base_out, r, 0, out_t.rows)],
            task_split_value=in_t.rows,
            flops=2.0 * in_t.rows * k * n,
            read_bytes=in_t.rows * in_row_b + w_t.rows * w_t.row_bytes,
            write_bytes=out_t.rows * out_row_b,
            meta={"fallback": True, **op.meta})]

    tds = []
    # Ragged expert-block tiles: ≤ gmm_m_split chunks per nonzero expert
    # (even or source-aligned boundaries per cfg.gmm_split_mode), last chunk
    # ragged — every routed row is covered exactly once.
    for (e, m, lo, hi) in plan.gmm_tiles(r, cfg.gmm_m_split,
                                         cfg.gmm_split_mode,
                                         cfg.tile_atom_nodes,
                                         cfg.tile_agg_rows):
        chunk = hi - lo
        k = in_row_b // _db(cfg)
        n = out_row_b // (_db(cfg) if task_type != "GMMWGrad" else 4)
        if task_type == "GMMWGrad":
            # dW[e] = act[e]^T @ grad[e]; "rows" of the weight tensor are
            # expert blocks; all m-chunks of expert e accumulate into it.
            out_rng = Range(base_out, r, e, e + 1)
            flops = 2.0 * chunk * k * (op.inputs[1].row_bytes // _db(cfg))
            reads = [Range(base_in, r, lo, hi),
                     Range(op.inputs[1].name.split("@")[0], r, lo, hi)]
            wbytes = out_t.row_bytes
        else:
            out_rng = Range(base_out, r, lo, hi)
            flops = 2.0 * chunk * k * n
            reads = [Range(base_in, r, lo, hi),
                     Range(base_w, r, e, e + 1)]
            wbytes = chunk * out_row_b
        tds.append(TaskDescriptor(
            task_type=task_type, queue_type=CTQ,
            inputs=reads, outputs=[out_rng],
            task_split_value=chunk,
            flops=flops,
            read_bytes=chunk * in_row_b + w_t.row_bytes,
            write_bytes=wbytes,
            meta={"expert": e, "m": m, **op.meta}))
    return tds


@fill_config("gmm")
def _fill_gmm(cfg: ScheduleConfig, op: OperatorNode) -> list[TaskDescriptor]:
    return _gmm_tiles(cfg, op, "GMM")


@fill_config("gmm_wgrad")
def _fill_gmm_wgrad(cfg: ScheduleConfig, op: OperatorNode) -> list[TaskDescriptor]:
    return _gmm_tiles(cfg, op, "GMMWGrad")


# -- Vector elementwise ops aligned to GMM row partitions --------------------

def _rowwise_tiles(cfg: ScheduleConfig, op: OperatorNode,
                   task_type: str) -> list[TaskDescriptor]:
    r = op.rank
    in_t = op.inputs[0]
    out_t = op.outputs[0]
    base_in = in_t.name.split("@")[0]
    base_out = out_t.name.split("@")[0]
    extra = [t for t in op.inputs[1:]]

    if op.task_num == 1:
        if in_t.rows == 0:
            return []
        reads = [Range(base_in, r, 0, in_t.rows)] + [
            Range(t.name.split("@")[0], r, 0, t.rows) for t in extra]
        return [TaskDescriptor(
            task_type=task_type, queue_type=VTQ,
            inputs=reads,
            outputs=[Range(base_out, r, 0, out_t.rows)],
            task_split_value=in_t.rows,
            read_bytes=sum(t.nbytes for t in op.inputs),
            write_bytes=out_t.nbytes,
            meta={"fallback": True})]

    if op.meta.get("plan_tiling") == "expert":
        # MoE-graph vector ops tile exactly like the GMMs they feed/follow —
        # plan-driven expert blocks with ragged m-chunks, so tile boundaries
        # stay aligned and the single-trigger invariant holds under skew.
        ranges = [(lo, hi, {"expert": e, "m": m})
                  for (e, m, lo, hi)
                  in cfg.routing.gmm_tiles(r, cfg.gmm_m_split,
                                           cfg.gmm_split_mode,
                                           cfg.tile_atom_nodes,
                                           cfg.tile_agg_rows)]
    else:
        # Generic even row split with a ragged last tile (no row dropped).
        chunk = -(-in_t.rows // op.task_num)
        bounds = []
        lo = 0
        while lo < in_t.rows:
            bounds.append((lo, min(lo + chunk, in_t.rows)))
            lo = bounds[-1][1]
        n = len(bounds)           # actual tile count (≤ requested)
        ranges = [(lo, hi, {"expert": i // max(1, n // cfg.e_loc)})
                  for i, (lo, hi) in enumerate(bounds)]
    tds = []
    for (lo, hi, meta) in ranges:
        chunk = hi - lo
        reads = [Range(base_in, r, lo, hi)] + [
            Range(t.name.split("@")[0], r, lo, hi) for t in extra]
        tds.append(TaskDescriptor(
            task_type=task_type, queue_type=VTQ,
            inputs=reads,
            outputs=[Range(base_out, r, lo, hi)],
            task_split_value=chunk,
            read_bytes=chunk * in_t.row_bytes
            + sum(chunk * t.row_bytes for t in extra),
            write_bytes=chunk * out_t.row_bytes,
            meta=meta))
    return tds


@fill_config("swiglu")
def _fill_swiglu(cfg: ScheduleConfig, op: OperatorNode) -> list[TaskDescriptor]:
    return _rowwise_tiles(cfg, op, "SwiGLU")


@fill_config("swiglu_grad")
def _fill_swiglu_grad(cfg: ScheduleConfig, op: OperatorNode) -> list[TaskDescriptor]:
    return _rowwise_tiles(cfg, op, "SwiGLUGrad")


# Generic elementwise ops used by the §6 microbenchmarks.
@fill_config("elementwise")
def _fill_elementwise(cfg: ScheduleConfig, op: OperatorNode) -> list[TaskDescriptor]:
    return _rowwise_tiles(cfg, op, op.meta.get("task_type", "Elementwise"))
