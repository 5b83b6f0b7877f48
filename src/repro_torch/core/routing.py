"""RoutingPlan — imbalanced routing as a first-class scheduling input.

The paper's controlled Table-3 setting routes the *same* number of tokens
from every source rank to every (destination rank, local expert) pair, which
is why the seed reproduction could describe routing with one scalar
(``ScheduleConfig.rows``). Real MoE batches are skewed: per-expert load
varies per step, some (src, dst, expert) cells are empty, and hotspot
traffic concentrates on a few experts. A :class:`RoutingPlan` captures the
full per-cell row-count matrix plus the derived buffer layouts, so the whole
compile-and-execute stack (ODG extents, tile generation, dependency
derivation, executor buffers, simulator costs) can operate on genuinely
imbalanced traffic. The balanced plan is the trivial special case and
reproduces the seed's schedules exactly.

Layout conventions (shared by every layer):

* **send buffer** on source rank *s* — rows grouped by (dst rank, local
  expert), destination-major: block (d, e) starts at ``send_offset(s, d, e)``
  and holds ``count(s, d, e)`` rows.
* **recv buffer** on destination rank *d* — rows grouped by (local expert,
  src rank), expert-major so each expert's rows are contiguous for the GMM:
  block (e, s) starts at ``recv_offset(d, e, s)``.

Plans are immutable and hashable (SSC-cache friendly); all offsets are
precomputed once per plan.
"""

from __future__ import annotations

import dataclasses
import functools
from functools import cached_property

import numpy as np


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _balanced_groups(sizes: list[int], k: int) -> list[int]:
    """Row counts of ≤ ``k`` contiguous, greedily cost-balanced cell groups.

    Partitions the ordered ``sizes`` sequence into at most ``k`` nonempty
    contiguous groups, closing a group once it reaches its fair share of the
    rows still ungrouped (or once only one cell per remaining group is
    left). Cells are never split, so every group boundary is a legal cut.
    """
    k = max(1, min(k, len(sizes)))
    total = sum(sizes)
    groups: list[int] = []
    acc = 0
    done = 0
    for i, c in enumerate(sizes):
        acc += c
        cells_left = len(sizes) - i - 1
        groups_left = k - len(groups) - 1
        if groups_left == 0:
            continue
        target = (total - done) / (groups_left + 1)
        if acc >= target or cells_left <= groups_left:
            groups.append(acc)
            done += acc
            acc = 0
    if acc:
        groups.append(acc)
    return groups


def _source_aligned_chunks(cells: list[int], m_split: int) -> list[int]:
    """Row counts of ≤ ``m_split`` single-trigger-safe chunks of one expert
    block whose nonzero source cells have ``cells`` rows (src order).

    With ``m_split`` ≤ the cell count, cells are greedily *grouped* into
    row-balanced chunks (boundaries only on cell edges). With a larger
    budget, cells are *refined*: each cell gets a piece budget proportional
    to its size (extra pieces go to the cell with the currently largest
    piece) and is cut evenly within itself. A chunk is therefore either a
    union of whole cells or strictly inside one cell — in both cases every
    dispatch cell feeds exactly one consumer event group.
    """
    k = max(1, m_split)
    if k <= len(cells):
        return _balanced_groups(cells, k)
    # Refinement budget: every cell gets one piece, and the k - n spare
    # pieces go one at a time to the cell with the largest current piece —
    # sum(pieces) never exceeds k, so the tile budget holds exactly.
    pieces = [1] * len(cells)
    spare = k - len(cells)
    while spare > 0:
        splittable = [i for i in range(len(cells)) if pieces[i] < cells[i]]
        if not splittable:
            break
        i = max(splittable, key=lambda i: cells[i] / pieces[i])
        pieces[i] += 1
        spare -= 1
    chunks: list[int] = []
    for c, p in zip(cells, pieces):
        piece = _ceil_div(c, p)
        lo = 0
        while lo < c:
            hi = min(lo + piece, c)
            chunks.append(hi - lo)
            lo = hi
    return chunks


def _node_atom_chunks(atoms: list[list[int]], m_split: int) -> list[int]:
    """Row counts of ≤ ``m_split`` chunks over node-grouped atoms.

    Each atom is the ordered cell list of either one same-node source cell
    or one remote node's aggregated cells (the write range of a single
    inter-node message). Grouping treats atoms as indivisible; refinement
    hands each oversized atom a proportional piece budget and recurses into
    :func:`_source_aligned_chunks` over *its* cells — so every chunk is a
    union of whole atoms, a union of whole cells inside one atom, or
    strictly inside one cell. All three keep both the aggregated-message
    producer and the per-cell combine consumers on single-event boundaries.
    """
    sizes = [sum(a) for a in atoms]
    k = max(1, m_split)
    if k <= len(atoms):
        return _balanced_groups(sizes, k)
    pieces = [1] * len(atoms)
    spare = k - len(atoms)
    while spare > 0:
        splittable = [i for i in range(len(atoms)) if pieces[i] < sizes[i]]
        if not splittable:
            break
        i = max(splittable, key=lambda i: sizes[i] / pieces[i])
        pieces[i] += 1
        spare -= 1
    chunks: list[int] = []
    for a, p in zip(atoms, pieces):
        if p <= 1:
            chunks.append(sum(a))
        else:
            chunks.extend(_source_aligned_chunks(a, p))
    return chunks


@dataclasses.dataclass(frozen=True)
class RoutingPlan:
    """Per-(src rank, dst rank, local expert) routed-row counts."""

    # counts[src][dst][local_expert] — nested tuples so the plan is hashable.
    counts: tuple

    # -- construction -------------------------------------------------------
    @classmethod
    def from_counts(cls, counts) -> "RoutingPlan":
        arr = np.asarray(counts, dtype=np.int64)
        if arr.ndim != 3 or arr.shape[0] != arr.shape[1]:
            raise ValueError(
                f"counts must be [ep, ep, e_loc], got shape {arr.shape}")
        if (arr < 0).any():
            raise ValueError("routed-row counts must be non-negative")
        return cls(counts=tuple(
            tuple(tuple(int(x) for x in dst) for dst in src) for src in arr))

    @classmethod
    def balanced(cls, ep: int, e_loc: int, rows: int) -> "RoutingPlan":
        """The paper's controlled setting: every cell carries ``rows``."""
        return balanced_plan(ep, e_loc, rows)

    # -- basic geometry -----------------------------------------------------
    @property
    def ep(self) -> int:
        return len(self.counts)

    @property
    def e_loc(self) -> int:
        return len(self.counts[0][0])

    @cached_property
    def _c(self) -> np.ndarray:
        return np.asarray(self.counts, dtype=np.int64)

    @cached_property
    def _send_off(self) -> np.ndarray:
        """[src, dst, e] start row within the source send buffer."""
        flat = self._c.reshape(self.ep, -1)
        off = np.zeros_like(flat)
        off[:, 1:] = np.cumsum(flat, axis=1)[:, :-1]
        out = off.reshape(self._c.shape)
        # Plans are shared (lru-cached balanced plan); a consumer writing
        # into the exposed table would corrupt every later compile.
        out.setflags(write=False)
        return out

    @cached_property
    def _recv_off(self) -> np.ndarray:
        """[dst, e, src] start row within the destination recv buffer."""
        per_dst = np.ascontiguousarray(np.transpose(self._c, (1, 2, 0)))
        flat = per_dst.reshape(self.ep, -1)
        off = np.zeros_like(flat)
        off[:, 1:] = np.cumsum(flat, axis=1)[:, :-1]
        out = off.reshape(per_dst.shape)
        out.setflags(write=False)
        return out

    # -- row accounting -----------------------------------------------------
    def count(self, src: int, dst: int, e: int) -> int:
        return int(self._c[src, dst, e])

    def send_rows(self, src: int) -> int:
        """Total rows in ``src``'s send (and return) buffer."""
        return int(self._c[src].sum())

    def recv_rows(self, dst: int) -> int:
        """Total rows in ``dst``'s dispatch-receive buffer."""
        return int(self._c[:, dst].sum())

    def expert_rows(self, rank: int, e: int) -> int:
        """Rows local expert ``e`` on ``rank`` processes (all sources)."""
        return int(self._c[:, rank, e].sum())

    def expert_offset(self, rank: int, e: int) -> int:
        """Start row of expert ``e``'s contiguous block in the recv buffer."""
        return int(self._recv_off[rank, e, 0])

    def send_offset(self, src: int, dst: int, e: int) -> int:
        return int(self._send_off[src, dst, e])

    def recv_offset(self, dst: int, e: int, src: int) -> int:
        return int(self._recv_off[dst, e, src])

    @property
    def send_offsets(self) -> np.ndarray:
        """Full [src, dst, e] start-row table (for vectorized consumers)."""
        return self._send_off

    @property
    def recv_offsets(self) -> np.ndarray:
        """Full [dst, e, src] start-row table (for vectorized consumers)."""
        return self._recv_off

    # -- cell enumeration (zero cells are skipped everywhere) ---------------
    def send_cells(self, src: int) -> list[tuple[int, int, int]]:
        """Nonzero (dst, e, count), destination-major = send-buffer order."""
        return [(d, e, int(self._c[src, d, e]))
                for d in range(self.ep) for e in range(self.e_loc)
                if self._c[src, d, e] > 0]

    def combine_cells(self, rank: int) -> list[tuple[int, int, int]]:
        """Nonzero (src, e, count) returned by ``rank``, source-major."""
        return [(s, e, int(self._c[s, rank, e]))
                for s in range(self.ep) for e in range(self.e_loc)
                if self._c[s, rank, e] > 0]

    def recv_layout_cells(self, rank: int) -> list[tuple[int, int, int]]:
        """Nonzero (e, src, count) in recv-buffer (expert-major) order."""
        return [(e, s, int(self._c[s, rank, e]))
                for e in range(self.e_loc) for s in range(self.ep)
                if self._c[s, rank, e] > 0]

    def n_send_cells(self, src: int) -> int:
        return int((self._c[src] > 0).sum())

    def n_combine_cells(self, rank: int) -> int:
        return int((self._c[:, rank] > 0).sum())

    # -- tile generation ----------------------------------------------------
    def _tile_atoms(self, rank: int, e: int, atom_nodes: int,
                    agg_rows: float | None = None) -> list[list[int]]:
        """Nested row atoms for expert ``e`` under two-level dispatch.

        With hierarchical dispatch the producer of the recv rows from a
        *remote node* is one aggregated inter-node put covering every
        source rank of that node, so tile boundaries may not fall across
        its span unless they stay inside it: each *aggregated* remote-node
        group contributes one atom carrying its per-source cell list,
        while same-node sources — and remote cells whose group stays on
        the direct path (see :func:`aggregate_group`) — keep single-cell
        atoms, their producers being per-cell flat puts. The
        src-ascending recv layout makes both kinds contiguous.
        """
        atoms: list[list[int]] = []
        my_node = rank // atom_nodes
        s = 0
        while s < self.ep:
            node = s // atom_nodes
            if node == my_node:
                c = int(self._c[s, rank, e])
                if c:
                    atoms.append([c])
                s += 1
            else:
                hi = (node + 1) * atom_nodes
                cells = [int(self._c[t, rank, e]) for t in range(s, hi)
                         if self._c[t, rank, e] > 0]
                if aggregate_group(cells, agg_rows):
                    atoms.append(cells)
                else:
                    atoms.extend([c] for c in cells)
                s = hi
        return atoms

    def gmm_tiles(self, rank: int, m_split: int = 1,
                  mode: str = "even",
                  atom_nodes: int | None = None,
                  agg_rows: float | None = None,
                  ) -> list[tuple[int, int, int, int]]:
        """(e, m, lo, hi) recv-buffer row ranges for GMM/vector tiles.

        ``mode="even"`` cuts each nonzero expert block into at most
        ``m_split`` chunks of ``ceil(rows / m_split)`` rows; the last chunk
        is ragged, so no rows are ever dropped. Empty experts produce no
        tiles. For the balanced plan with ``m_split | rows`` this reduces to
        the seed's even grid — but on an arbitrary imbalanced plan the even
        boundaries straddle dispatch-cell boundaries and the scheduler
        rejects the schedule (single-trigger violation).

        ``mode="source_aligned"`` respects the source-cell structure of the
        src-major recv layout: with ``m_split`` at or below the number of
        nonzero cells, cells are greedily grouped into ≤ ``m_split``
        row-balanced chunks whose boundaries lie only on source-cell edges
        — every tile is a union of whole dispatch cells. With a larger
        budget, oversized cells are additionally refined by even cuts
        *strictly inside* one cell (budget apportioned by cell size, still
        ≤ ``m_split`` tiles total). Either way each producer cell overlaps
        exactly the consumer tiles of a single event group, so the
        single-trigger invariant holds for *any* plan, however skewed — a
        hotspot cell carrying most of a rank's tokens gets fine-grained
        tiles instead of one monolithic chain.
        """
        if mode not in ("even", "source_aligned"):
            raise ValueError(f"unknown gmm split mode {mode!r}")
        if atom_nodes is not None and mode != "source_aligned":
            raise ValueError(
                "node-grouped tiling atoms require mode='source_aligned'")
        tiles: list[tuple[int, int, int, int]] = []
        for e in range(self.e_loc):
            rows = self.expert_rows(rank, e)
            if rows == 0:
                continue
            base = self.expert_offset(rank, e)
            if mode == "even":
                chunk = _ceil_div(rows, max(1, m_split))
                lo, m = 0, 0
                while lo < rows:
                    hi = min(lo + chunk, rows)
                    tiles.append((e, m, base + lo, base + hi))
                    lo, m = hi, m + 1
                continue
            if atom_nodes is None:
                cells = [int(self._c[s, rank, e]) for s in range(self.ep)
                         if self._c[s, rank, e] > 0]
                chunks = _source_aligned_chunks(cells, m_split)
            else:
                chunks = _node_atom_chunks(
                    self._tile_atoms(rank, e, atom_nodes, agg_rows), m_split)
            lo = 0
            for m, group_rows in enumerate(chunks):
                tiles.append((e, m, base + lo, base + lo + group_rows))
                lo += group_rows
        return tiles

    def n_gmm_tiles(self, rank: int, m_split: int = 1,
                    mode: str = "even", atom_nodes: int | None = None,
                    agg_rows: float | None = None) -> int:
        return len(self.gmm_tiles(rank, m_split, mode, atom_nodes, agg_rows))

    # -- skew diagnostics ---------------------------------------------------
    @property
    def total_rows(self) -> int:
        return int(self._c.sum())

    def is_balanced(self) -> bool:
        return bool((self._c == self._c.flat[0]).all())

    def expert_imbalance(self) -> float:
        """max / mean load over all (rank, expert) slots (1.0 = balanced)."""
        loads = self._c.sum(axis=0).reshape(-1).astype(np.float64)
        mean = loads.mean()
        return float(loads.max() / mean) if mean > 0 else 1.0

    def rank_imbalance(self) -> float:
        """max / mean recv rows over ranks (straggler potential)."""
        loads = self._c.sum(axis=(0, 2)).astype(np.float64)
        mean = loads.mean()
        return float(loads.max() / mean) if mean > 0 else 1.0


def aggregate_group(cells: list[int], agg_rows: float | None) -> bool:
    """Should a remote-node (dst, expert) group take the aggregated path?

    ``cells`` are the group's nonzero per-source row counts; ``agg_rows``
    is the row count whose inter-node transfer time equals one inter-node
    hop latency (``inter_hop_us * inter_gbps / row_bytes``), or None for
    aggregate-everything.

    Aggregation saves ``(len(cells) - 1)`` per-message hop latencies on the
    inter-node NIC but costs pipelining: the destination's GMM tiles wait
    for the *whole* aggregated message where flat dispatch streams
    per-cell. So aggregate exactly when the latency saved covers the
    serialization exposed — total rows within ``(n_cells - 1) * agg_rows``
    — and never for singleton groups, where the extra intra-node hop buys
    nothing. Latency-bound sparse traffic aggregates; byte-bound hot cells
    stay on the direct per-cell path and keep fine-grained overlap.
    """
    if len(cells) < 2:
        return False
    if agg_rows is None:
        return True
    return sum(cells) <= (len(cells) - 1) * agg_rows


class HierDispatch:
    """Two-level dispatch geometry for one (plan, node_size) pair.

    Maps the flat per-cell dispatch onto DeepEP-style hierarchical
    transfers. Tokens from source node *A* bound for a remote (dst rank
    ``d``, expert ``e``) are first gathered — per source cell, over the
    fast intra-node links — into a staging buffer on a *leader* rank of
    node *A*, then take the slow inter-node hop as **one** aggregated
    message per (leader, d, e) group.

    Aggregation is selective: only groups where :func:`aggregate_group`
    says the hop-latency amortization beats the lost per-cell pipelining
    (under the ``agg_rows`` threshold the cost model derives from the
    topology) are staged; everything else keeps the flat direct path.

    Leadership is spread over the node by hashing the (d, e) group:
    ``leader(A, d, e) = A*R + (d*e_loc + e) % R`` — so a node's
    inter-node egress is balanced across its R ranks instead of
    serialising through one NIC.

    Boundary contract (what makes the tasks legal for the scheduler's
    single-trigger event machinery):

    * every gather task copies exactly one dispatch cell, so each gather
      is consumed by exactly one inter-node group task;
    * the staging buffer on a leader is laid out (d, e)-major with the
      node's sources ascending inside a group — so every group is one
      contiguous input range;
    * the recv buffer is (e, src)-major, so a group's landing zone
      (expert ``e``, sources of node A) is one contiguous output range —
      bit-identical rows to what flat per-cell dispatch would deliver;
    * GMM tiles treat each aggregated group's rows as one indivisible
      atom (``RoutingPlan._tile_atoms``), so no tile boundary splits an
      aggregated message's write range.
    """

    def __init__(self, plan: RoutingPlan, node_size: int,
                 agg_rows: float | None = None):
        if node_size < 1 or plan.ep % node_size:
            raise ValueError(
                f"node_size={node_size} must divide ep={plan.ep}")
        self.plan = plan
        self.node_size = node_size
        self.n_nodes = plan.ep // node_size
        self.agg_rows = agg_rows
        self._layouts: dict[int, tuple] = {}

    def aggregated(self, src_node: int, d: int, e: int) -> bool:
        """Does (src_node → dst ``d``, expert ``e``) take the staged path?"""
        if src_node == d // self.node_size:
            return False
        p, R = self.plan, self.node_size
        cells = [p.count(s, d, e) for s in range(src_node * R,
                                                 (src_node + 1) * R)
                 if p.count(s, d, e) > 0]
        return aggregate_group(cells, self.agg_rows)

    # -- node arithmetic ----------------------------------------------------
    def node_of(self, rank: int) -> int:
        return rank // self.node_size

    def same_node(self, a: int, b: int) -> bool:
        return a // self.node_size == b // self.node_size

    def leader(self, src_node: int, d: int, e: int) -> int:
        return (src_node * self.node_size
                + (d * self.plan.e_loc + e) % self.node_size)

    # -- per-leader staging layout ------------------------------------------
    def _layout(self, leader: int) -> tuple:
        cached = self._layouts.get(leader)
        if cached is not None:
            return cached
        p, R = self.plan, self.node_size
        node = leader // R
        s_lo, s_hi = node * R, (node + 1) * R
        groups: list[tuple[int, int, tuple[tuple[int, int], ...], int]] = []
        group_off: dict[tuple[int, int], int] = {}
        cell_off: dict[tuple[int, int, int], int] = {}
        lo = 0
        for d in range(p.ep):
            if d // R == node:
                continue
            for e in range(p.e_loc):
                if self.leader(node, d, e) != leader:
                    continue
                srcs = tuple((s, p.count(s, d, e)) for s in range(s_lo, s_hi)
                             if p.count(s, d, e) > 0)
                if not aggregate_group([c for _, c in srcs], self.agg_rows):
                    continue
                group_off[(d, e)] = lo
                run = lo
                for s, c in srcs:
                    cell_off[(d, e, s)] = run
                    run += c
                groups.append((d, e, srcs, run - lo))
                lo = run
        out = (tuple(groups), group_off, cell_off, lo)
        self._layouts[leader] = out
        return out

    def stage_groups(self, leader: int):
        """Ordered (d, e, ((src, count), ...), total_rows) groups homed at
        ``leader`` — the staging-buffer layout, (d, e)-major."""
        return self._layout(leader)[0]

    def n_stage_groups(self, leader: int) -> int:
        return len(self._layout(leader)[0])

    def group_offset(self, leader: int, d: int, e: int) -> int:
        """Staging-buffer start row of the (d, e) group."""
        return self._layout(leader)[1][(d, e)]

    def cell_offset(self, leader: int, d: int, e: int, s: int) -> int:
        """Staging-buffer start row of source ``s``'s cell in group (d, e)."""
        return self._layout(leader)[2][(d, e, s)]

    def stage_rows(self, leader: int) -> int:
        """Total staging-buffer rows homed at ``leader``."""
        return self._layout(leader)[3]

    def recv_node_span(self, d: int, e: int, src_node: int) -> tuple[int, int]:
        """(lo, rows): the contiguous recv-buffer landing zone on ``d`` for
        expert ``e`` rows from every source rank of ``src_node``."""
        p, R = self.plan, self.node_size
        lo = p.recv_offset(d, e, src_node * R)
        rows = int(sum(p.count(s, d, e)
                       for s in range(src_node * R, (src_node + 1) * R)))
        return lo, rows


@functools.lru_cache(maxsize=256)
def balanced_plan(ep: int, e_loc: int, rows: int) -> RoutingPlan:
    """Cached trivial plan — ``ScheduleConfig.routing`` hits this per task."""
    return RoutingPlan.from_counts(np.full((ep, ep, e_loc), rows,
                                           dtype=np.int64))


# ---------------------------------------------------------------------------
# Plan generators for tests and benchmarks.
# ---------------------------------------------------------------------------

def skewed_plan(ep: int, e_loc: int, rows: int,
                alpha: float = 1.0) -> RoutingPlan:
    """Deterministic Zipf-like skew over global experts.

    Every source rank still emits ``ep * e_loc * rows`` rows total (token
    count is conserved); expert ``g`` receives a share ∝ ``(g+1)^-alpha``.
    ``alpha=0`` is the balanced plan; larger alpha concentrates load.
    Shares are apportioned by largest remainder so totals are exact.
    """
    n_slots = ep * e_loc
    total = n_slots * rows
    w = np.arange(1, n_slots + 1, dtype=np.float64) ** (-alpha)
    w /= w.sum()
    ideal = w * total
    base = np.floor(ideal).astype(np.int64)
    rem = total - int(base.sum())
    order = np.argsort(-(ideal - base))
    base[order[:rem]] += 1
    counts = np.broadcast_to(base.reshape(ep, e_loc),
                             (ep, ep, e_loc)).copy()
    return RoutingPlan.from_counts(counts)


def hotspot_plan(ep: int, e_loc: int, rows: int,
                 background: int = 0) -> RoutingPlan:
    """Hot (rank 0, expert 0) cell; token count per source is conserved.

    ``background=0`` (default) is the degenerate hotspot: every source sends
    *all* of its ``ep * e_loc * rows`` tokens to (rank 0, expert 0).
    ``background > 0`` keeps roughly that many rows in every other cell —
    source rank *s* keeps ``background + s`` (deterministically varied so
    the plan is *not* per-source-uniform): the realistic hot-expert profile
    where all ranks still receive traffic but rank 0 dominates, and where
    even chunk boundaries straddle source cells — ``gmm_m_split > 1`` then
    requires source-aligned tiling.
    """
    total = ep * e_loc * rows
    if background and (background + ep - 1) * (ep * e_loc - 1) > total:
        raise ValueError("background traffic exceeds per-source token count")
    counts = np.zeros((ep, ep, e_loc), dtype=np.int64)
    for s in range(ep):
        if background:
            counts[s, :, :] = background + s
        counts[s, 0, 0] = total - counts[s].sum() + counts[s, 0, 0]
    return RoutingPlan.from_counts(counts)


def node_limited_plan(ep: int, e_loc: int, rows: int,
                      node_size: int = 4, m_nodes: int = 1,
                      leak: float = 0.05) -> RoutingPlan:
    """Node-limited routing: each token's experts confined to ≤ M nodes.

    Source rank ``s`` routes a ``1 - leak`` share of its ``ep*e_loc*rows``
    token budget uniformly over the experts of its ``m_nodes`` *allowed*
    nodes (its own node plus the next ``m_nodes - 1`` on the node ring,
    the Pangu-Ultra-MoE node-limited profile) and spreads the remaining
    ``leak`` share thinly over every other slot — many tiny cross-node
    cells, the traffic shape where per-message latency dominates and
    hierarchical aggregation pays off most. Shares are apportioned by
    largest remainder, so per-source totals are exact.
    """
    if node_size < 1 or ep % node_size:
        raise ValueError(f"node_size={node_size} must divide ep={ep}")
    if not 0.0 <= leak < 1.0:
        raise ValueError(f"leak must be in [0, 1), got {leak}")
    n_nodes = ep // node_size
    m = max(1, min(m_nodes, n_nodes))
    total = ep * e_loc * rows
    counts = np.zeros((ep, ep, e_loc), dtype=np.int64)
    for s in range(ep):
        home = s // node_size
        allowed = {(home + j) % n_nodes for j in range(m)}
        in_slots = len(allowed) * node_size * e_loc
        out_slots = ep * e_loc - in_slots
        w = np.empty(ep * e_loc, dtype=np.float64)
        for d in range(ep):
            if d // node_size in allowed:
                wd = (1.0 - leak) / in_slots if out_slots else 1.0 / in_slots
            else:
                wd = leak / out_slots
            w[d * e_loc:(d + 1) * e_loc] = wd
        ideal = (w / w.sum()) * total
        base = np.floor(ideal).astype(np.int64)
        rem = total - int(base.sum())
        order = np.argsort(-(ideal - base), kind="stable")
        base[order[:rem]] += 1
        counts[s] = base.reshape(ep, e_loc)
    return RoutingPlan.from_counts(counts)


def random_plan(ep: int, e_loc: int, max_rows: int,
                rng: np.random.Generator,
                p_zero: float = 0.3) -> RoutingPlan:
    """Sparse random plan: each cell is 0 w.p. ``p_zero``, else U[1, max]."""
    counts = rng.integers(1, max_rows + 1, size=(ep, ep, e_loc))
    counts = np.where(rng.random((ep, ep, e_loc)) < p_zero, 0, counts)
    if counts.sum() == 0:           # keep at least one routed row
        counts[0, 0, 0] = max_rows
    return RoutingPlan.from_counts(counts)
