"""Expert-parallel MoE execution — counterpart of ``repro.parallel.ep``.

Two modes over the ``model`` axis of a :class:`repro_torch.launch.mesh.Mesh`,
both numerically the single-device MoE at the same capacity:

* ``baseline``      — a collective all-to-all dispatch and return with full
  barriers: the host-driven path the paper profiles in §2.3;
* ``hyperparallel`` — the all-to-all decomposed into per-destination chunks
  moved by ``ppermute`` in a RATR-rotated ring (source r sends to r + k at
  step k), each arriving chunk's expert FFN issued at once, its result
  riding the reverse ring home (§4.1/§4.4).

Each rank routes its own tokens with the replicated router into per-(dst,
expert) send buffers of a fixed pair capacity, and combines the returned
rows with its top-k weights. The ranks' programs run on the mesh's comm
(``parallel.comm``): on one card every rank in turn, each collective a
device copy; over ``torch.distributed``, one rank a process.

With ``EPConfig(use_pallas=True)``, the port's default, each rank's expert
FFN runs the Hopper kernels (``kernels.ops.moe_expert_ffn``: ``gmm_swiglu``
then ``gmm``; under autograd their backward, ``gmm_swiglu_bwd`` and two
``gmm`` calls). The reference's default is its einsum path; the port's
model MoE runs the kernels, and so does its EP. ``use_pallas=False`` runs
the plain FFN (``models.moe.expert_ffn``).

``ring_chunk_caps`` also serves the decode-trace replay
(``launch/replay.py``), which counts the distinct cap tuples a bucket policy
gives the ring.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops
from ..models.moe import MoEConfig, expert_ffn, router_topk


@dataclasses.dataclass(frozen=True)
class EPConfig:
    mode: str = "hyperparallel"     # baseline | hyperparallel
    axis: str = "model"
    capacity_factor: float = 1.25
    use_pallas: bool = True         # the Hopper kernels inside the shard
    # EP-over-DP (the paper's dp=32/ep=32 layout): tokens are batch-sharded
    # over every mesh axis incl. the EP axis; the a2a still runs over `axis`.
    dp_batch: bool = False


def _pair_capacity(t_loc: int, mc: MoEConfig, ep: int,
                   cap_factor: float) -> int:
    """Tokens per (destination rank, local expert) pair from one device."""
    per_slot = t_loc * mc.top_k / mc.e_total
    return max(8, int(np.ceil(per_slot * cap_factor / 8)) * 8)


def plan_from_dispatch(top_i, mc: MoEConfig, ep: int, C: int):
    """RoutingPlan of the rows ``_dispatch_buffers`` fills.

    ``top_i``: per-source-rank expert choices [ep, T_loc, k] (numpy or a
    tensor). Capacity is per (source rank, global expert), the slot
    semantics of ``_dispatch_buffers``: ``counts[s, d, e] = min(#choices,
    C)``.
    """
    from ..core.routing import RoutingPlan

    ti = (top_i.detach().cpu().numpy() if isinstance(top_i, torch.Tensor)
          else np.asarray(top_i))
    if ti.ndim != 3 or ti.shape[0] != ep:
        raise ValueError(f"expected [ep, T_loc, k] choices, got {ti.shape}")
    if mc.e_total % ep:
        raise ValueError(f"e_total={mc.e_total} not divisible by ep={ep}")
    e_loc = mc.e_total // ep
    counts = np.zeros((ep, ep, e_loc), dtype=np.int64)
    for s in range(ep):
        hist = np.bincount(ti[s].reshape(-1), minlength=mc.e_total)
        counts[s] = np.minimum(hist, C).reshape(ep, e_loc)
    return RoutingPlan.from_counts(counts)


def ring_chunk_caps(plan, ep: int, topology=None, bucket=None,
                    inter_bucket=None) -> tuple:
    """Per-ring-step row caps from a :class:`RoutingPlan`.

    ``caps[k]`` is the largest per-(dst, expert) row count any source rank
    moves at ring distance ``k`` (source ``s`` → destination ``(s + k) %
    ep``); a step whose cap is 0 carries only padding for every rank. All
    ranks move one shape per step, so the straggler source sets the cap.

    With a :class:`repro_torch.core.hardware.Topology`, ring step ``k`` is
    an inter-node step when any source's hop at distance ``k`` crosses a
    node boundary: intra-node steps quantize their caps with ``bucket``,
    inter-node steps with ``inter_bucket`` (anything
    ``BucketSpec.from_any`` takes; ``None`` leaves that class exact).
    Quantization only rounds caps up, and zero caps stay zero.
    """
    if plan.ep != ep:
        raise ValueError(f"plan ep={plan.ep} != mesh ep={ep}")
    c = np.asarray(plan.counts, dtype=np.int64)       # [src, dst, e_loc]
    caps = []
    for k in range(ep):
        dst = (np.arange(ep) + k) % ep
        caps.append(int(c[np.arange(ep), dst].max()))
    if bucket is None and inter_bucket is None:
        return tuple(caps)
    if inter_bucket is not None and topology is None:
        raise ValueError(
            "inter_bucket needs a topology to tell inter-node ring steps "
            "from intra-node ones")
    from ..core.buckets import BucketSpec

    def quantize(cap: int, b) -> int:
        if b is None or cap == 0:
            return cap
        return int(BucketSpec.from_any(b).quantize(np.array([cap]))[0])

    out = []
    for k, cap in enumerate(caps):
        inter = topology is not None and any(
            not topology.same_node(s, (s + k) % ep) for s in range(ep))
        b = inter_bucket if (inter and inter_bucket is not None) else bucket
        out.append(quantize(cap, b))
    return tuple(out)


def _expert_ffn_local(w_in, w_down, x, act, use_pallas):
    """One rank's experts on their rows, x [e_loc, C, d] → [e_loc, C, d]."""
    x = x.contiguous()
    if use_pallas:
        trainable = torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w_in, w_down))
        return ops.moe_expert_ffn(x, w_in, w_down, act, trainable=trainable)
    return expert_ffn(w_in, w_down, x, act)


def _dispatch_buffers(x2d, router, mc: MoEConfig, ep: int, C: int):
    """Local routing + scatter into the per-(dst, expert) send buffer.

    Returns (send [ep, e_loc, C, d], top_p, top_i, slot) where slot is the
    position within the (dst, expert) capacity bucket (C = dropped). Slots
    follow the rows' order in ``x2d`` ((b, s) order of the rank's shard).
    """
    T, d = x2d.shape
    e_loc = mc.e_total // ep
    top_p, top_i = router_topk(router, x2d, mc)
    flat_e = top_i.reshape(-1)
    onehot = F.one_hot(flat_e, mc.e_total)
    pos = torch.cumsum(onehot, dim=0) - 1
    slot = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    keep = slot < C
    slot = torch.where(keep, slot, C)
    top_p = top_p * keep.reshape(top_p.shape)

    send = torch.zeros((mc.e_total, C + 1, d), dtype=x2d.dtype,
                       device=x2d.device)
    # Each token's row once per choice, (t, k) order; its backward sums
    # over k in place of a scatter-add, so the grads are deterministic.
    k = top_i.shape[1]
    rows = x2d[:, None].expand(T, k, d).reshape(T * k, d)
    send = send.index_put((flat_e, slot), rows, accumulate=True)
    send = send[:, :C].reshape(ep, e_loc, C, d)
    return send, top_p, top_i, slot.reshape(top_i.shape)


def _combine(back, top_p, top_i, slot, T, d, ep, e_loc, C, dtype):
    """back: [ep(dst), e_loc, C, d] results at their send slots → [T, d]."""
    flat = torch.cat([back.reshape(ep * e_loc * C, d),
                      back.new_zeros((1, d))], dim=0)
    # Global flat index of (expert_global, slot): expert-major like send.
    gather_idx = torch.where(slot < C, top_i * C + slot, ep * e_loc * C)
    y = torch.einsum("tkd,tk->td", flat[gather_idx], top_p.to(back.dtype))
    return y.to(dtype)


def _split_rule(epc: EPConfig, B: int, S: int, ep: int, n_dp: int):
    """The reference's ``x_spec``: (split the batch over the data groups,
    the dim of a group's rows split over ``model`` or None)."""
    if epc.dp_batch and B % (ep * n_dp) == 0:
        return True, 0
    if B > 1 and B % n_dp:
        raise ValueError(f"batch {B} does not split over {n_dp} data groups")
    return B > 1, (1 if S % ep == 0 and S > 1 else None)


def make_moe_ep(mesh, epc: EPConfig, act: str = "swiglu", plan=None,
                bucket=None, topology=None, inter_bucket=None,
                mode: str = "tp_sp", rows_repeat: bool = False):
    """Returns ``moe_impl(params, x, mc)`` running EP over the model axis.

    On a mesh of virtual ranks ``params`` and ``x`` [B, S, d] are the
    whole tensors. ``x`` is split as the reference's ``x_spec``: the batch
    over the data groups when B > 1 (over every axis with ``dp_batch``),
    the sequence over ``model`` when S % ep == 0 and S > 1; otherwise every
    rank routes the whole group's rows (decode), and the redundant work is
    done. ``mode`` is not read there.

    On a process mesh (``launch.mesh.dist_mesh(dims)``) ``x`` is this
    rank's own rows, as the reference's ``x_spec`` for ``mode`` places
    them, and the rank routes them:

    * ``tp_sp``: its sequence chunk of its data group's rows (the
      sequence-parallel residual), or, where the sequence does not split
      (S == 1 or S % ep != 0), the group's rows, which every rank of the
      group routes: the redundant work is done. The experts are this
      rank's block ``[E / ep, ...]`` (the param spec's ``model`` split).
    * ``ep_dp`` (``dp_batch``): its rows of a batch split over every axis;
      its own experts, as in tp_sp.
    * ``zero1``: its rows of a batch split over every axis; an all-to-all
      over the model group first gives each rank its sequence chunk of the
      group's rows, as the reference's ``x_spec`` (data, model) does, and
      a second one brings the results back. The experts are the whole
      replicated leaves, of which the rank runs its block; their grad is
      that block's, zero elsewhere (the data-parallel reduction sums it).

    ``rows_repeat`` (zero1 and ep_dp): the batch's spec leaves ``model``
    out (too few rows for every rank), so every rank of a model group holds
    the group's rows. The rank then routes its own sequence chunk of them,
    as the reference's ``x_spec`` (data, model) places them in zero1, and
    in ep_dp where ``B % (ep · data groups)``, and the results are
    all-gathered over the sequence; the all-gather's transpose sums the
    ranks' cotangents, as the data-parallel reduction expects of every
    rank's rows.
    Where the sequence does not split (S == 1, a decode step, or S % ep)
    the group's rows are routed whole by every rank, as the reference's
    ``x_spec`` (data, None) places them: repeated rows as they are, zero1's
    rows split over ``model`` all-gathered first.

    The router's grad is this rank's rows' alone: the data-parallel
    reduction (``launch.steps.reduce_grads``) sums it.

    ``plan``: a host-known :class:`RoutingPlan` (``plan_from_dispatch`` on
    this batch's routing, or one covering it). In ``hyperparallel`` mode
    the ring then moves plan-sized chunks, each step's sliced to the
    largest row count any source sends at that distance, and skips steps
    that carry only padding. ``bucket`` quantizes the plan's counts before
    the caps are taken. A plan that undercounts the routing (a stale one)
    drops its overflow rows: their results stay zero, never gathered to
    the wrong place. ``topology`` switches cap quantization to per link
    class (``ring_chunk_caps``).
    """
    ep = mesh.shape[epc.axis]
    comm = mesh.comm
    local = mesh.local_rows
    if epc.axis != "model" or comm.ep != ep:
        raise ValueError(f"EP runs over the mesh's model axis, whose comm "
                         f"has {comm.ep} ranks, not over {epc.axis!r}")
    if epc.mode not in ("baseline", "hyperparallel"):
        raise ValueError(f"EP mode {epc.mode!r}: baseline or hyperparallel")
    if mode not in ("tp_sp", "zero1", "ep_dp"):
        raise ValueError(f"mode {mode!r}: tp_sp, zero1 or ep_dp")
    if local and (mode == "ep_dp") != epc.dp_batch:
        raise ValueError("on a process mesh ep_dp and EPConfig.dp_batch go "
                         "together")
    if rows_repeat and not (local and mode in ("zero1", "ep_dp")):
        raise ValueError("rows_repeat is zero1's and ep_dp's on a process "
                         "mesh")
    if (bucket is not None or inter_bucket is not None) and plan is None:
        raise ValueError(
            "make_moe_ep(bucket=.../inter_bucket=...) quantizes a routing "
            "plan's ring caps — pass plan= as well (without one the "
            "fixed-capacity path runs and the bucket would be silently "
            "ignored)")
    if topology is not None and plan is not None:
        ring_caps = ring_chunk_caps(plan, ep, topology=topology,
                                    bucket=bucket, inter_bucket=inter_bucket)
    else:
        if bucket is not None:
            from ..core.buckets import BucketSpec
            plan = BucketSpec.from_any(bucket).apply(plan)
        ring_caps = ring_chunk_caps(plan, ep) if plan is not None else None

    def ffn(w_in, w_down, x):
        return _expert_ffn_local(w_in, w_down, x, act, epc.use_pallas)

    def baseline(sends, w_ins, w_downs):
        e_loc, C, d = sends[0].shape[1:]
        recv = comm.all_to_all(sends)                    # [src, e_loc, C, d]
        ys = []
        for r, w_in, w_down in zip(recv, w_ins, w_downs):
            xin = r.transpose(0, 1).reshape(e_loc, ep * C, d)
            y = ffn(w_in, w_down, xin)
            ys.append(y.reshape(e_loc, ep, C, d).transpose(0, 1))
        return comm.all_to_all(ys)

    def ring(sends, w_ins, w_downs):
        """RATR ring: step k moves the chunk for destination r + k, the
        FFN of the chunk that just arrived runs at once, and its result
        rides the reverse ring back. Step 0 is the rank-local chunk."""
        e_loc, C, d = sends[0].shape[1:]
        blocks = [[None] * ep for _ in sends]
        for k in range(ep):
            ck = C if ring_caps is None else min(C, ring_caps[k])
            if ck == 0:
                continue        # every rank's step-k chunk is pure padding
            # Tokens fill each slot from its head, so the sliced rows are
            # exactly the routed ones.
            chunks = [s[(r + k) % ep, :, :ck].contiguous()
                      for s, r in zip(sends, comm.ranks)]
            arrived = chunks if k == 0 else comm.ppermute(chunks, k)
            ys = [ffn(wi, wd, a) for a, wi, wd in zip(arrived, w_ins,
                                                        w_downs)]
            returned = ys if k == 0 else comm.ppermute(ys, -k)
            for b, r, y in zip(blocks, comm.ranks, returned):
                b[(r + k) % ep] = F.pad(y, (0, 0, 0, C - ck))
        zero = sends[0].new_zeros((e_loc, C, d))
        return [torch.stack([zero if t is None else t for t in b])
                for b in blocks]

    def run_ranks(xs, routers, w_ins, w_downs, mc):
        """Each rank's program on its rows ``xs`` [b, s, d]."""
        d = xs[0].shape[-1]
        e_loc = mc.e_total // ep
        sends, routed = [], []
        for x_loc, router in zip(xs, routers):
            T = x_loc.shape[0] * x_loc.shape[1]
            C = _pair_capacity(T, mc, ep, epc.capacity_factor)
            send, top_p, top_i, slot = _dispatch_buffers(
                x_loc.reshape(T, d), router, mc, ep, C)
            sends.append(send)
            routed.append((top_p, top_i, slot, T, C))
        run = baseline if epc.mode == "baseline" else ring
        backs = run(sends, w_ins, w_downs)
        return [_combine(back, top_p, top_i, slot, T, d, ep, e_loc, C,
                         x_loc.dtype).reshape(x_loc.shape)
                for back, (top_p, top_i, slot, T, C), x_loc
                in zip(backs, routed, xs)]

    def run_group(params, x, dim, mc):
        xs = comm.shard(x, dim)
        ys = run_ranks(xs, comm.shard(params["router"], None),
                       comm.shard(params["w_in"], 0),
                       comm.shard(params["w_down"], 0), mc)
        return comm.unshard(ys, dim)

    def seq_chunks(x):
        """[b, S, d] rows of each rank → [ep * b, S / ep, d]: the group's
        rows in rank order, this rank's chunk of their sequence."""
        b, S, d = x.shape
        x = x.reshape(b, ep, S // ep, d).transpose(0, 1).contiguous()
        return comm.all_to_all([x])[0].reshape(ep * b, S // ep, d)

    def seq_rows(y):
        """The inverse of ``seq_chunks``."""
        n, s, d = y.shape
        y = comm.all_to_all([y.reshape(ep, n // ep, s, d).contiguous()])[0]
        return y.transpose(0, 1).reshape(n // ep, ep * s, d)

    def run_local(params, x, mc):
        w_in, w_down = params["w_in"], params["w_down"]
        if mode == "zero1":
            e_loc = mc.e_total // ep
            w_in, w_down = (w.narrow(0, comm.rank * e_loc, e_loc)
                            for w in (w_in, w_down))
        elif w_in.shape[0] * ep != mc.e_total:
            raise ValueError(f"{w_in.shape[0]} local experts on each of "
                             f"{ep} ranks, not {mc.e_total}")
        run = partial(run_ranks, routers=[params["router"]], w_ins=[w_in],
                      w_downs=[w_down], mc=mc)
        if (mode != "zero1" and not rows_repeat) or ep == 1:
            return run([x])[0]
        S = x.shape[1]
        if S % ep or S == 1:
            # The sequence does not split (a decode step): the group's rows,
            # which every rank routes, as the reference's x_spec (data,
            # None) places them; zero1's rows split over model are
            # gathered first and the rank keeps its own.
            if rows_repeat:
                return run([x])[0]
            b = x.shape[0]
            return run([comm.all_gather_dim(x, 0)])[0].narrow(
                0, comm.rank * b, b)
        if rows_repeat:
            c = S // ep
            own = x[:, comm.rank * c:(comm.rank + 1) * c]
            return comm.all_gather_dim(run([own])[0], 1)
        return seq_rows(run([seq_chunks(x)])[0])

    def moe_impl(params, x, mc: MoEConfig):
        if mc.e_total % ep:
            raise ValueError(f"e_total={mc.e_total} not divisible by "
                             f"ep={ep}")
        if local:
            return run_local(params, x, mc)
        B, S, _ = x.shape
        n_dp = mesh.dp_size
        split, dim = _split_rule(epc, B, S, ep, n_dp)
        groups = torch.chunk(x, n_dp, 0) if split else [x] * n_dp
        ys = [run_group(params, g, dim, mc) for g in groups]
        # A batch replicated over the data groups: group 0's output.
        return torch.cat(ys, 0) if split else ys[0]

    return moe_impl
