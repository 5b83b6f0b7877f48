"""Mixture-of-Experts FFN: router + expert execution — counterpart of
``repro.models.moe``.

* ``moe_dense_ref`` — one-hot einsum over all experts; the oracle.
* ``moe_grouped``  — capacity-based dispatch/combine with sorted token
  buffers feeding a grouped GEMM; ``gmm_fn=kernels.ops.moe_expert_ffn`` runs
  it through the Hopper kernels (the model's default).

``plan_from_routing`` bridges this layer to the scheduling stack
(``repro_torch.core``): it turns a batch's actual top-k assignment into a
compilable ``RoutingPlan`` on the host, in numpy, and ``bridge_dispatch`` /
``bridge_combine`` move the tokens into and out of the plan's send buffers
on the tensors' device; ``fused_boundary_forward`` / ``_backward`` are
their per-rank composition, the LayerBoundary remap of a fused block.

Routing uses fixed expert capacity:
``capacity = ceil(tokens · top_k / E · capacity_factor)``; overflow tokens
are dropped (the dense ref applies the same mask).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .layers import glu_act


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN width (branch width)
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # Experts padded up so E % ep == 0 (router never selects padding).
    n_padding_experts: int = 0

    @property
    def e_total(self) -> int:
        return self.n_experts + self.n_padding_experts


def init_moe(gen: torch.Generator, d_model: int, mc: MoEConfig,
             dtype=torch.float32):
    """Router in fp32 (it always runs in fp32); expert weights in ``dtype``."""
    E = mc.e_total
    std = d_model ** -0.5

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=gen.device) * scale

    return {
        "router": normal((d_model, E), std),
        "w_in": normal((E, d_model, 2 * mc.d_expert), std).to(dtype),
        "w_down": normal((E, mc.d_expert, d_model),
                         mc.d_expert ** -0.5).to(dtype),
    }


def router_topk(p_router, x, mc: MoEConfig):
    """Top-k routing with renormalized softmax probs.

    x: [T, d] → (probs [T, k], idx [T, k]).  Padding experts are masked out.
    The logits are fp32 whatever the router's dtype, as JAX's einsum promotes
    a bf16 router (training casts every float leaf to bf16).
    """
    logits = x.float() @ p_router.float()
    if mc.n_padding_experts:
        pad_mask = torch.arange(mc.e_total, device=x.device) >= mc.n_experts
        logits = torch.where(pad_mask[None, :], -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, mc.top_k, dim=-1)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    return top_p, top_i


def load_balance_loss(p_router, x, mc: MoEConfig):
    """Switch-style auxiliary load-balancing loss + router z-loss.

    aux = E · Σ_e f_e · P_e (f: the fraction of tokens whose top-1 is e,
    P: the mean router prob), least at uniform routing; z keeps the router
    logits bounded. Padding experts are masked out. x: [T, d] → (aux, z),
    fp32 scalars."""
    logits = x.float() @ p_router.float()
    if mc.n_padding_experts:
        pad = torch.arange(mc.e_total, device=x.device) >= mc.n_experts
        logits = torch.where(pad[None, :], -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    f = torch.mean(F.one_hot(top1, mc.e_total).float(), dim=0)
    P = torch.mean(probs, dim=0)
    aux = mc.n_experts * torch.sum(f * P)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return aux, z


def capacity(tokens: int, mc: MoEConfig, ep: int = 1) -> int:
    """Per-expert capacity, rounded up to a multiple of ``ep``."""
    c = int(math.ceil(tokens * mc.top_k / mc.e_total * mc.capacity_factor))
    return max(ep, ((c + ep - 1) // ep) * ep)


def expert_ffn(w_in, w_down, x, act: str = "swiglu"):
    """x: [E, C, d] per-expert batches → [E, C, d]."""
    h = torch.bmm(x, w_in.to(x.dtype))
    h = glu_act(h, act)
    return torch.bmm(h, w_down.to(x.dtype))


def make_dispatch(top_p, top_i, T: int, E: int, C: int):
    """Position-in-expert assignment under fixed capacity.

    Returns (combine_w [T,k], expert [T,k], slot [T,k] in [0, C) or C for
    dropped).
    """
    k = top_i.shape[1]
    flat_e = top_i.reshape(-1)                                  # [T*k]
    # position of each (token, choice) within its expert, in token order
    onehot = F.one_hot(flat_e, E)                               # [T*k, E]
    pos = torch.cumsum(onehot, dim=0) - 1                       # running idx
    slot = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    keep = slot < C
    return (top_p * keep.reshape(T, k)), flat_e.reshape(T, k), \
        torch.where(keep, slot, C).reshape(T, k)


def _routed(params, xt, mc: MoEConfig, C: int):
    top_p, top_i = router_topk(params["router"], xt, mc)
    return make_dispatch(top_p, top_i, xt.shape[0], mc.e_total, C)


def moe_dense_ref(params, x, mc: MoEConfig, act: str = "swiglu",
                  cap: Optional[int] = None):
    """One-hot dense-einsum oracle (same capacity-drop mask, no scatter)."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    E = mc.e_total
    C = cap or capacity(T, mc)
    top_p, top_i, slot = _routed(params, xt, mc, C)
    # dispatch_mask[t, k, e, c]: token t's k-th choice occupies (e, c);
    # a dropped choice (slot C) occupies nothing.
    e_oh = F.one_hot(top_i, E).to(xt.dtype)                    # [T,k,E]
    c_oh = F.one_hot(slot, C + 1)[..., :C].to(xt.dtype)        # [T,k,C]
    disp_mask = torch.einsum("tke,tkc->tec", e_oh, c_oh)
    disp = torch.einsum("tec,td->ecd", disp_mask, xt)
    out_e = expert_ffn(params["w_in"], params["w_down"], disp, act)
    comb = torch.einsum("tke,tkc,tk->tec", e_oh, c_oh, top_p.to(xt.dtype))
    y = torch.einsum("tec,ecd->td", comb, out_e)
    return y.reshape(B, S, d)


def moe_grouped(params, x, mc: MoEConfig, act: str = "swiglu",
                cap: Optional[int] = None, gmm_fn=None):
    """Sorted/capacity dispatch → grouped FFN → weighted combine.

    ``gmm_fn(x_disp [E, C, d], w_in, w_down, act)`` overrides the expert FFN
    (``kernels.ops.moe_expert_ffn`` runs the Hopper kernels); defaults to the
    einsum path.
    """
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    E = mc.e_total
    C = cap or capacity(T, mc)
    top_p, top_i, slot = _routed(params, xt, mc, C)

    # Dispatch: scatter tokens into [E, C, d] expert buffers; row C takes
    # every dropped choice and is cut off.
    disp = torch.zeros((E, C + 1, d), dtype=x.dtype, device=x.device)
    tok_idx = torch.arange(T, device=x.device)[:, None].expand_as(top_i)
    disp.index_put_((top_i.reshape(-1), slot.reshape(-1)),
                    xt[tok_idx.reshape(-1)], accumulate=True)
    disp = disp[:, :C].contiguous()

    if gmm_fn is not None:
        out_e = gmm_fn(disp, params["w_in"], params["w_down"], act)
    else:
        out_e = expert_ffn(params["w_in"], params["w_down"], disp, act)

    # Combine: gather back with routing weights, summed in x's dtype in k
    # order (a dropped choice reads the zero row C).
    out_e = torch.cat([out_e, torch.zeros_like(out_e[:, :1])], dim=1)
    y = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for j in range(mc.top_k):
        y = y + (out_e[top_i[:, j], slot[:, j]]
                 * top_p[:, j][:, None].to(x.dtype))
    return y.reshape(B, S, d)


# ---------------------------------------------------------------------------
# RoutingPlan bridge — real router output → compilable schedule input.
#
# The bridge turns a batch's actual (imbalanced) expert assignment into a
# RoutingPlan plus the row bookkeeping needed to scatter tokens into the
# plan's send-buffer layout and to apply top-k combine weights to the
# executor's returned rows. Tokens are split contiguously over EP source
# ranks, so a token's global order equals (src-major, local order) — the
# slot order `moe_grouped` produces. The plan and ``send_row`` are built on
# the host from ``top_i``; only the index tensors derived from ``send_row``
# go to the device.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RoutingBridge:
    """A RoutingPlan plus token↔row maps for one routed batch."""

    plan: "object"              # repro_torch.core.routing.RoutingPlan
    # Row index into source rank s's send buffer for choice (s, t, k);
    # -1 where the choice was dropped by capacity.
    send_row: np.ndarray        # int64 [ep, T_loc, k]
    _rows: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def ep(self) -> int:
        return self.send_row.shape[0]

    @property
    def dropped(self) -> bool:
        return bool((self.send_row < 0).any())

    def rows_on(self, device) -> torch.Tensor:
        """``send_row`` as an int64 tensor on ``device``, uploaded once per
        bridge (through pinned memory without waiting on a card)."""
        device = torch.device(device)
        if device not in self._rows:
            self._rows[device] = _to_device(self.send_row, device)
        return self._rows[device]


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``. To a card it is copied from pinned memory
    without blocking the host, so it adds no wait on the device's queue."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _cumcount(keys: np.ndarray) -> np.ndarray:
    """Occurrence index of each element within its key group, in order.

    Vectorized (stable argsort + group starts): this runs once per routed
    batch on [T*k] choices, so no per-choice Python loop.
    """
    n = keys.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    starts = np.r_[0, np.flatnonzero(np.diff(sorted_keys)) + 1]
    group_start = np.repeat(starts, np.diff(np.r_[starts, n]))
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n, dtype=np.int64) - group_start
    return rank


def bucket_counts(counts: np.ndarray, bucket=1) -> np.ndarray:
    """Quantize per-(src, dst, expert) row counts into shape buckets.

    ``bucket`` is any :func:`repro_torch.core.buckets.BucketSpec.from_any`
    argument (a linear bucket-size int, a ``BucketSpec``, or a spec string
    like ``"geometric:8"``). Nonzero cells round *up* to their policy bucket
    (the padding rows stay zero-filled in the send buffers, so execution is
    unchanged); empty cells stay empty, so plan sparsity is preserved. Two
    batches whose counts land in the same buckets produce identical plans
    and therefore share one SSC cache entry.
    """
    from ..core.buckets import BucketSpec
    spec = BucketSpec.from_any(bucket)
    if spec.is_exact:
        return counts
    return spec.quantize(counts)


def _per_rank(top_i, mc: MoEConfig, ep: int) -> np.ndarray:
    """``top_i`` [T, k] or [ep, T_loc, k] as a host array [ep, T_loc, k]."""
    ti = np.asarray(top_i)
    if ti.ndim == 2:
        T, k = ti.shape
        if T % ep:
            raise ValueError(f"T={T} tokens not divisible by ep={ep}")
        ti = ti.reshape(ep, T // ep, k)
    if ti.shape[0] != ep:
        raise ValueError(f"leading dim {ti.shape[0]} != ep={ep}")
    if mc.e_total % ep:
        raise ValueError(f"e_total={mc.e_total} not divisible by ep={ep}")
    return ti


def routed_counts(top_i, mc: MoEConfig, ep: int) -> np.ndarray:
    """Exact per-(src, dst, expert) row counts of one batch's routing, as
    int64 ``[ep, ep, e_loc]`` (``top_i`` as in :func:`plan_from_routing`).
    """
    ti = _per_rank(top_i, mc, ep)
    e_loc = mc.e_total // ep
    _, t_loc, k = ti.shape
    flat = ti.reshape(-1).astype(np.int64)
    src_idx = np.repeat(np.arange(ep, dtype=np.int64), t_loc * k)
    counts = np.zeros((ep, ep, e_loc), dtype=np.int64)
    np.add.at(counts, (src_idx, flat // e_loc, flat % e_loc), 1)
    return counts


def plan_from_routing(top_i, mc: MoEConfig, ep: int,
                      capacity: Optional[int] = None,
                      bucket=None) -> RoutingBridge:
    """Turn real router output into a compilable :class:`RoutingBridge`.

    ``top_i``: expert indices [T, k] (tokens split contiguously over ``ep``
    source ranks; T % ep == 0) or already per-rank [ep, T_loc, k], as a host
    array. ``capacity``: per-(global expert) token cap applied in global
    token order, matching ``make_dispatch``; ``None`` = dropless.
    ``bucket``: a ``BucketSpec`` (or anything ``BucketSpec.from_any``
    accepts; ``None`` = exact) quantizing each cell's row count up to its
    shape bucket. The actual rows occupy the head of each padded cell and
    the tail rows stay zero.
    """
    from ..core.buckets import BucketSpec
    from ..core.routing import RoutingPlan

    spec = BucketSpec.from_any(bucket)
    ti = _per_rank(top_i, mc, ep)
    _, t_loc, k = ti.shape
    e_loc = mc.e_total // ep

    flat = ti.reshape(-1).astype(np.int64)      # global (src-major) order
    src_idx = np.repeat(np.arange(ep, dtype=np.int64), t_loc * k)
    d_idx = flat // e_loc
    e_idx = flat % e_loc

    # Position of each choice within its global expert, in global order —
    # the same cumulative count `make_dispatch` computes.
    slot = _cumcount(flat)
    keep = (slot < capacity) if capacity is not None else np.ones(
        flat.shape[0], dtype=bool)

    counts = np.zeros((ep, ep, e_loc), dtype=np.int64)
    np.add.at(counts, (src_idx[keep], d_idx[keep], e_idx[keep]), 1)
    plan = RoutingPlan.from_counts(bucket_counts(counts, spec))

    # Row within the (src, dst, expert) send cell = occurrence index among
    # the *kept* choices of that cell, in local order.
    send_row = np.full(flat.shape[0], -1, dtype=np.int64)
    kept = np.nonzero(keep)[0]
    cell = (src_idx[kept] * ep + d_idx[kept]) * e_loc + e_idx[kept]
    send_row[kept] = (plan.send_offsets.reshape(-1)[cell]
                      + _cumcount(cell))
    return RoutingBridge(plan=plan,
                         send_row=send_row.reshape(ep, t_loc, k))


def bridge_dispatch(bridge: RoutingBridge, x) -> list:
    """Scatter tokens ``x`` [ep, T_loc, d] into per-rank plan send buffers
    (fp32, on x's device); padding rows stay zero."""
    ep, t_loc, k = bridge.send_row.shape
    rows = bridge.rows_on(x.device)
    bufs = []
    for s in range(ep):
        # One spare row takes the dropped choices (send row -1) and is cut.
        n = bridge.plan.send_rows(s)
        buf = torch.zeros((n + 1, x.shape[-1]), dtype=torch.float32,
                          device=x.device)
        buf[rows[s]] = x[s].float()[:, None, :].expand(t_loc, k, -1)
        bufs.append(buf[:n])
    return bufs


def bridge_combine(bridge: RoutingBridge, y_ret: list, top_p):
    """Weight-and-gather executor return buffers back to [ep, T_loc, d].

    Applies the same per-choice accumulation ``moe_grouped`` performs, in
    choice order, in fp32; dropped choices contribute zero.
    """
    ep, t_loc, k = bridge.send_row.shape
    top_p = top_p.float().reshape(ep, t_loc, k)
    rows = bridge.rows_on(top_p.device)
    dropped = bridge.dropped
    d = y_ret[0].shape[-1] if y_ret else 0
    y = torch.zeros((ep, t_loc, d), dtype=torch.float32,
                    device=top_p.device)
    for s in range(ep):
        if not y_ret[s].shape[0]:
            continue                 # every choice of rank s was dropped
        for j in range(k):
            r = rows[s, :, j]
            if not dropped:
                y[s] += top_p[s, :, j, None] * y_ret[s][r]
                continue
            c = top_p[s, :, j, None] * y_ret[s][r.clamp(min=0)]
            y[s] += torch.where((r >= 0)[:, None], c, 0.0)
    return y


def fused_boundary_forward(bridge_out: RoutingBridge,
                           bridge_in: RoutingBridge,
                           top_p_out, d_model: int) -> dict:
    """Per-rank remap fns for one forward junction of a fused schedule.

    The junction composes layer i's combine-weighted gather (the rank-r
    slice of :func:`bridge_combine` under ``bridge_out``/``top_p_out``)
    with layer i+1's send-buffer scatter (the rank-r slice of
    :func:`bridge_dispatch` under ``bridge_in``). Both are rank-local — a
    token's returned rows and its next-layer send rows live on its own
    source rank — so the per-rank restriction equals the full ops run one
    after the other bit for bit; the statements below are theirs, in the
    same order, on ``top_p_out``'s device.

    Returns ``{rank: fn}`` with the executor's LayerBoundary contract
    ``fn(full_y_ret_or_None, lo, hi) -> [hi - lo, d_model]``; the full
    remap is memoized per rank, so tile granularity costs nothing.
    """
    ep, t_loc, k_out = bridge_out.send_row.shape
    k_in = bridge_in.send_row.shape[2]
    tp = top_p_out.float().reshape(ep, t_loc, k_out)
    dev = tp.device
    rows_out = bridge_out.rows_on(dev)
    rows_in = bridge_in.rows_on(dev)
    dropped = bridge_out.dropped
    fns = {}
    for r in range(ep):
        def fn(data, lo, hi, r=r, _memo={}):
            if "buf" not in _memo:
                y = torch.zeros((t_loc, d_model), dtype=torch.float32,
                                device=dev)
                if data is not None and data.shape[0]:
                    for j in range(k_out):
                        rr = rows_out[r, :, j]
                        if not dropped:
                            y += tp[r, :, j, None] * data[rr]
                            continue
                        c = tp[r, :, j, None] * data[rr.clamp(min=0)]
                        y += torch.where((rr >= 0)[:, None], c, 0.0)
                n = bridge_in.plan.send_rows(r)
                buf = torch.zeros((n + 1, d_model), dtype=torch.float32,
                                  device=dev)
                buf[rows_in[r]] = y[:, None, :].expand(t_loc, k_in, -1)
                _memo["buf"] = buf[:n]
            return _memo["buf"][lo:hi]
        fns[r] = fn
    return fns


def fused_boundary_backward(bridge_out: RoutingBridge,
                            bridge_in: RoutingBridge,
                            top_p_out, d_model: int) -> dict:
    """Backward twin of :func:`fused_boundary_forward`.

    Maps ``dx_ret`` of layer i+1's backward fragment (gradient w.r.t. that
    layer's send buffer) to ``dy_src`` of layer i's (gradient w.r.t. its
    return buffer): gather-sum the dispatched copies back to tokens
    (dispatch transpose, in choice order), then scatter the combine
    weights' products into the upstream send layout (combine transpose).
    Rank-local for the same reason as the forward, and statement for
    statement the dropless backward's: a choice owns at most one send row,
    so the scatter is an assignment (the reference accumulates with
    ``np.add.at``); a dropped choice's row is the spare one, cut off.
    """
    ep, t_loc, k_out = bridge_out.send_row.shape
    k_in = bridge_in.send_row.shape[2]
    tp = top_p_out.float().reshape(ep, t_loc, k_out)
    dev = tp.device
    rows_out = bridge_out.rows_on(dev)
    rows_in = bridge_in.rows_on(dev)
    dropped = bridge_in.dropped
    fns = {}
    for r in range(ep):
        def fn(data, lo, hi, r=r, _memo={}):
            if "buf" not in _memo:
                dx_tok = torch.zeros((t_loc, d_model), dtype=torch.float32,
                                     device=dev)
                if data is not None and data.shape[0]:
                    for j in range(k_in):
                        rr = rows_in[r, :, j]
                        if not dropped:
                            dx_tok += data[rr]
                            continue
                        dx_tok += torch.where((rr >= 0)[:, None],
                                              data[rr.clamp(min=0)], 0.0)
                n = bridge_out.plan.send_rows(r)
                dy = torch.zeros((n + 1, d_model), dtype=torch.float32,
                                 device=dev)
                dy[rows_out[r]] = tp[r][:, :, None] * dx_tok[:, None, :]
                _memo["buf"] = dy[:n]
            return _memo["buf"][lo:hi]
        fns[r] = fn
    return fns
