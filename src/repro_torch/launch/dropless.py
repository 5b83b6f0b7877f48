"""Dropless, data-dependent MoE execution for the training step —
counterpart of ``repro.launch.dropless``.

Each batch's actual router output becomes a ``RoutingPlan`` through
``plan_from_routing(capacity=None)`` (no token is dropped), shape-bucketed
(``bucket``: a ``repro_torch.core.buckets.BucketSpec``) so routing jitter
maps to a stable key; the plan's schedule is fetched from — or compiled
into — a :class:`~repro_torch.core.ssc.SSCCache`, and the plan-sized tile
taskflow runs in ``core.executor`` instead of the fixed-capacity FFN.

The seam is the model's ``moe_impl(params, x, mc)``. The router runs in
torch, so its gradient flows through ``top_p``; the Dispatch → GMM1 →
SwiGLU → GMM2 → Combine fragment is one ``torch.autograd.Function``.
Where the reference sends x, the weights and the cotangent to numpy through
``jax.pure_callback``, here only ``top_i`` goes to the host (once per
forward call; the backward keeps the host copy): the plan, the schedule and
the walk over its tasks are host work, while x, the weights, every buffer
and every gradient stay on x's device, and the GMM tiles launch the port's
``gmm`` kernel. As in the reference the fragment computes in fp32 — its
inputs cast to float32 on every call, nothing cached across steps — and
its output is cast back to x's dtype; the backward recomputes the saved
activations with ``core.executor.reference_forward_plan`` (the same ``gmm``
calls as the forward's tiles) and runs the backward-direction schedule.

On a rank of a process mesh (``make_moe_dropless(mesh=, rules=)``, in
tp_sp, zero1 and ep_dp) the router runs on the rank's rows, and
:class:`MeshRows` gathers every token and every expert so that each rank
runs the reference's fragment over the whole global batch and keeps its
own rows of the output. The reference runs it once, on device 0; the port
runs it on every rank.

:class:`FusedDroplessMoE` runs K such layers as one multi-fragment taskflow
(``core/fusion``) per direction, layer j's Combine joined to layer j+1's
Dispatch by LayerBoundary tiles (``models.moe.fused_boundary_forward`` /
``fused_boundary_backward`` on the device), or — ``fuse=False`` — as K
per-layer schedules back to back, which it equals bit for bit.
``DroplessMoE.rescale`` moves a handle to a smaller or larger mesh, or
off lost ranks (``core/elastic``), re-keying the shared cache.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..core import executor as ex
from ..core import fusion as fu
from ..core.odg import ScheduleConfig
from ..core.ssc import SSCCache
from ..device import resolve_device
from ..models.moe import (bridge_combine, bridge_dispatch,
                          fused_boundary_backward, fused_boundary_forward,
                          plan_from_routing, router_topk)


@dataclasses.dataclass(frozen=True)
class DroplessConfig:
    """Configuration of the dropless data-dependent training path.

    ``ep`` is the size of the *compiled* EP group: tokens are split
    contiguously over ``ep`` virtual source ranks and experts over ``ep``
    expert shards (on one device, the ranks are virtual and their puts are
    device copies). ``bucket`` quantizes per-cell plan counts into shape
    buckets: a :class:`repro_torch.core.buckets.BucketSpec` or anything
    ``BucketSpec.from_any`` accepts (``"geometric:8"``, a fitted ladder,
    an int; 1 = exact plans). ``pipeline`` is a schedule-pass pipeline spec
    applied to both directions — or ``"auto"``, resolved per batch plan and
    direction by the cost-model selector inside ``SSCCache``.
    """

    ep: int = 1
    bucket: object = 16              # BucketSpec | int | str | key tuple
    gmm_m_split: int = 1
    gmm_split_mode: str = "source_aligned"
    pipeline: tuple | str = ("ratr", "gmm_interleave")
    cache_entries: int = 64

    def bucket_spec(self):
        """``bucket`` as a ``BucketSpec``."""
        from ..core.buckets import BucketSpec
        return BucketSpec.from_any(self.bucket)

    def __post_init__(self):
        # Fail at construction, not at the first train step: the only valid
        # string is "auto", bare pass names must be registered, and the
        # bucket spec must parse.
        self.bucket_spec()
        from ..core.passes import get_pass
        if isinstance(self.pipeline, str):
            if self.pipeline != "auto":
                raise ValueError(
                    f"pipeline={self.pipeline!r}: the only string spec is "
                    f'"auto"; for a named pipeline use '
                    f"core.passes.pipeline_arg({self.pipeline!r}) or a "
                    f"pass-name tuple")
            return
        for item in self.pipeline:
            if isinstance(item, str):
                get_pass(item)          # fail fast on unknown names

    def pipeline_spec(self):
        """The ``pipeline=`` argument for ``SSCCache``: ``"auto"`` or a
        list spec."""
        return self.pipeline if isinstance(self.pipeline, str) \
            else list(self.pipeline)


_PROCESS_CACHE: Optional[SSCCache] = None


def get_process_cache(max_entries: int = 64) -> SSCCache:
    """The process-level SSC cache shared by every dropless handle built
    without ``cache=``. It keeps the largest bound ever requested."""
    global _PROCESS_CACHE
    if _PROCESS_CACHE is None:
        _PROCESS_CACHE = SSCCache(max_entries=max_entries)
    elif max_entries > _PROCESS_CACHE.max_entries:
        _PROCESS_CACHE.max_entries = max_entries
    return _PROCESS_CACHE


class DroplessMoE:
    """A dropless ``moe_impl`` plus its schedule cache handle. ``mesh``,
    ``rules`` and ``global_batch``: the impl of a rank of a process mesh
    (:class:`MeshRows`)."""

    def __init__(self, dc: DroplessConfig, act: str = "swiglu",
                 cache: Optional[SSCCache] = None, *, mesh=None, rules=None,
                 global_batch: Optional[int] = None):
        if act != "swiglu":
            raise ValueError(
                f"dropless schedules execute the SwiGLU fragment; act={act!r}")
        self.dc = dc
        self.cache = cache if cache is not None else get_process_cache(
            dc.cache_entries)
        self.rows = (None if mesh is None
                     else MeshRows(mesh, rules, global_batch))
        self.impl = _make_impl(dc, self.cache, rows=self.rows)
        self._snapshot = self._counters()

    def _counters(self) -> tuple:
        info = self.cache.info()
        return (info["hits"], info["misses"], info["evictions"],
                info["exact_rows"], info["padded_rows"])

    def rescale(self, new_ep: Optional[int] = None,
                dead_ranks=None) -> "DroplessMoE":
        """A fresh impl on the surviving mesh, sharing this handle's cache.

        Pass the new mesh size or the lost ranks (``new_ep`` defaults to
        the survivor count). The shared ``SSCCache`` is re-keyed for the new
        mesh: old-mesh entries stay resident but bear the LRU pressure
        first, and the new handle's plans compile with ``ep``-tagged bucket
        keys. Remapped plans (``core.elastic.remap_plan``) execute bit for
        bit like plans built natively on the small mesh, so no schedule
        state needs migrating.
        """
        if new_ep is None:
            if dead_ranks is None:
                raise ValueError("pass new_ep= and/or dead_ranks=")
            from ..core.elastic import surviving_ranks
            new_ep = len(surviving_ranks(self.dc.ep, dead_ranks))
        new_ep = int(new_ep)
        if new_ep < 1:
            raise ValueError(f"new_ep must be >= 1, got {new_ep}")
        if self.rows is not None:
            raise ValueError("a process mesh's dropless impl keeps its "
                             "mesh: rescale the one-process handle")
        self.cache.rekey_for_mesh(new_ep)
        return DroplessMoE(dataclasses.replace(self.dc, ep=new_ep),
                           cache=self.cache)

    def step_stats(self) -> dict:
        """Cache counter deltas since this handle's previous call (the
        snapshot lives on the handle, so consumers of a shared cache do not
        zero each other's per-step numbers)."""
        cur = self._counters()
        last, self._snapshot = self._snapshot, cur
        d_exact, d_pad = cur[3] - last[3], cur[4] - last[4]
        return {"hits": cur[0] - last[0], "misses": cur[1] - last[1],
                "evictions": cur[2] - last[2],
                "entries": self.cache.info()["entries"],
                "pad_ratio": d_pad / d_exact if d_exact else 1.0}


def make_moe_dropless(model_cfg, dc: DroplessConfig,
                      cache: Optional[SSCCache] = None, *, mesh=None,
                      rules=None,
                      global_batch: Optional[int] = None) -> DroplessMoE:
    """Build the dropless MoE impl for a model config (validates shapes);
    with a process ``mesh`` and its ``rules``, the impl of this rank
    (:class:`MeshRows`; ``global_batch``: the whole batch's rows, by
    default as many as split over every axis the mode splits rows over)."""
    mc = model_cfg.moe
    if mc is None:
        raise ValueError("dropless MoE requires a MoE model config")
    if mc.e_total % dc.ep:
        raise ValueError(f"e_total={mc.e_total} not divisible by "
                         f"dropless ep={dc.ep}")
    return DroplessMoE(dc, act=model_cfg.act, cache=cache, mesh=mesh,
                       rules=rules, global_batch=global_batch)


class MeshRows:
    """Where a rank's rows of a process mesh (``launch.mesh.dist_mesh``)
    sit in the whole batch, and the gathers that give every rank the whole
    batch: the process-mesh seam of the dropless fragment.

    The reference runs the fragment once over the whole global batch, its
    ``pure_callback`` placed on device 0: every token's ``xt``, ``top_p``
    and ``top_i`` and every expert's weights gathered there, ``y``
    scattered back. Here every rank gathers them and runs the whole
    fragment (``DroplessConfig.ep`` virtual source ranks, the plan built
    from every token's routing, so every rank's SSC cache sees the
    reference's lookups), then keeps its own rows of ``y``. The tokens are
    in the reference's order, ``[B, S]`` flattened:

    * tp_sp: the rank's sequence chunk (``parallel.tp.TensorParallel.moe``
      says whether it holds one: ``moe_chunk``) gathered over ``model``,
      then the rows over the axes the batch spec splits them over (the
      data axes);
    * zero1 and ep_dp: the rows over the axes the batch spec splits them
      over; where ``model`` is not among them (too few rows for every rank)
      every rank of a model group holds the group's rows, and each distinct
      row is taken once.

    The gathers are ``DistComm.all_gather_dim`` (``top_i`` without a grad),
    whose backward reduce-scatters: the cotangent a rank feeds the
    fragment's backward covers its own rows, zero elsewhere, so its
    ``dxt``, ``dtop_p`` and expert grads are partial shares, which the
    transposes sum (``parallel.comm``'s convention). The expert weights
    arrive whole, gathered over ``model`` where the spec splits them (ep_dp
    and tp_sp; tp_sp's FSDP gather over ``data`` is
    ``TensorParallel.layer``'s, before the impl).
    """

    def __init__(self, mesh, rules, global_batch: Optional[int] = None):
        if rules is None or not mesh.local_rows:
            raise ValueError("MeshRows places a rank of a process mesh "
                             "(launch.mesh.dist_mesh) with its rules")
        self.mesh, self.rules = mesh, rules
        self.global_batch = global_batch

    def row_axes(self, b: int) -> tuple:
        """The axes the batch spec splits the rows over, for a block of
        ``b`` rows."""
        from ..parallel.sharding import spec_axes
        B = self.global_batch or b * math.prod(
            n for a, n in self.mesh.shape.items()
            if self.rules.mode != "tp_sp" or a != "model")
        return spec_axes(self.rules.batch_spec({"labels": (B,)})["labels"])

    def _chunk(self) -> bool:
        """Whether the rank holds its sequence chunk of the rows."""
        if self.rules.mode != "tp_sp":
            return False
        from ..parallel.ctx import current_tensor_parallel
        tp = current_tensor_parallel()
        return tp is not None and tp.moe_chunk

    def whole(self, t):
        """The rank's ``t`` [b, s, ...] as the whole batch's [B, S, ...]."""
        if self._chunk():
            t = self.mesh.comm.all_gather_dim(t, 1)
        axes = self.row_axes(t.shape[0])
        return self.mesh.axes_comm(axes).all_gather_dim(t, 0) if axes else t

    def own(self, y, b: int, s: int):
        """The rank's block [b, s, ...] of ``y`` [B, S, ...], as
        :meth:`whole` placed it."""
        axes = self.row_axes(b)
        if axes:
            y = y.narrow(0, self.mesh.axes_comm(axes).rank * b, b)
        if self._chunk():
            y = y.narrow(1, self.mesh.comm.rank * s, s)
        return y

    def experts(self, w, e_total: int):
        """An expert leaf whole: gathered over ``model`` where its spec
        splits the experts."""
        if w.shape[0] == e_total:
            return w
        if w.shape[0] * self.mesh.shape["model"] != e_total:
            raise ValueError(f"{w.shape[0]} experts on each of the "
                             f"{self.mesh.shape['model']} ranks of the "
                             f"model axis, not {e_total}")
        return self.mesh.comm.all_gather_dim(w, 0)


# ---------------------------------------------------------------------------
# The schedulable fragment.
# ---------------------------------------------------------------------------


def _schedule_cfg(dc: DroplessConfig, plan, d_model: int,
                  d_ff: int) -> ScheduleConfig:
    return ScheduleConfig(ep=dc.ep, e_loc=plan.e_loc, rows=0,
                          d_model=d_model, d_ff=d_ff,
                          gmm_m_split=dc.gmm_m_split,
                          gmm_split_mode=dc.gmm_split_mode, plan=plan,
                          bucket=dc.bucket_spec().key())


def _bridge_of(dc: DroplessConfig, top_i, mc,
               cache: Optional[SSCCache] = None):
    """The batch's dropless bridge from host ``top_i``; with ``cache``, its
    exact rows (the full [ep, T_loc, k] choice grid) and its bucketed
    plan's rows are recorded for ``pad_ratio``."""
    bridge = plan_from_routing(top_i, mc, dc.ep, capacity=None,
                               bucket=dc.bucket_spec())
    if cache is not None:
        cache.record_rows(int(bridge.send_row.size),
                          bridge.plan.total_rows)
    return bridge


def _expert_weights(dc: DroplessConfig, mc, w_in, w_down):
    """fp32 per-rank expert weights [ep, e_loc, d, 2f] / [ep, e_loc, f, d]
    (a copy when the weights are not fp32, freed after the call)."""
    e_loc = mc.e_total // dc.ep
    d, f = w_in.shape[1], mc.d_expert
    return (w_in.float().reshape(dc.ep, e_loc, d, 2 * f),
            w_down.float().reshape(dc.ep, e_loc, f, d))


def _exec_forward(dc: DroplessConfig, cache: SSCCache, mc,
                  xt, top_p, top_i, w1, w2) -> torch.Tensor:
    """Plan → cached schedule → executor → combined tokens.

    ``xt`` [T, d] and ``top_p`` [T, k] on the device, ``top_i`` [T, k] on
    the host, ``w1``/``w2`` per-rank fp32 expert weights. Returns
    ``y [T, d]`` float32 on xt's device.
    """
    T, d = xt.shape
    bridge = _bridge_of(dc, top_i, mc, cache)
    plan = bridge.plan
    cfg = _schedule_cfg(dc, plan, d, mc.d_expert)
    sched = cache.get_or_compile(cfg, "forward",
                                 pipeline=dc.pipeline_spec())
    x_src = bridge_dispatch(bridge, xt.reshape(dc.ep, T // dc.ep, d))
    st = ex.ExecutorState(cfg, xt.device)
    ex.load_forward_state_plan(cfg, st, x_src, w1, w2)
    ex.execute(sched, st, rng=np.random.default_rng(0))
    return bridge_combine(bridge, _ret_bufs(st, "y_ret", plan, d),
                          top_p).reshape(T, d)


def _one_row_per_choice(bridge) -> None:
    """A dropless choice owns one send row, so the cotangent scatter of
    :func:`_dy_of` is a plain assignment (the reference accumulates with
    ``np.add.at``)."""
    for s in range(bridge.ep):
        r = bridge.send_row[s]
        if (r < 0).any() or np.unique(r).size != r.size:
            raise AssertionError(f"rank {s}: dropless send rows are not "
                                 f"one per choice")


def _dy_of(bridge, tp3, g3) -> list:
    """Per-row cotangent entering a backward fragment: dy[row] = p · g of
    the row's token, per rank (``tp3`` [ep, T_loc, k], ``g3`` [ep, T_loc,
    d], fp32 on the device)."""
    rows = bridge.rows_on(g3.device)
    dy = []
    for s in range(bridge.ep):
        buf = torch.zeros((bridge.plan.send_rows(s), g3.shape[-1]),
                          dtype=torch.float32, device=g3.device)
        buf[rows[s]] = tp3[s][:, :, None] * g3[s][:, None, :]
        dy.append(buf)
    return dy


def _token_grads(bridge, dx_ret: list, y_ret: list, g3, tp3):
    """(dx of the tokens [ep, T_loc, d], d top_p [ep, T_loc, k]) of one
    layer from its ``dx_ret`` buffers, accumulated in choice order."""
    ep, t_loc, k = bridge.send_row.shape
    dev = g3.device
    rows = bridge.rows_on(dev)
    dxt = torch.zeros((ep, t_loc, g3.shape[-1]), dtype=torch.float32,
                      device=dev)
    dtp = torch.zeros((ep, t_loc, k), dtype=torch.float32, device=dev)
    for s in range(ep):
        if not bridge.plan.send_rows(s):
            continue
        for j in range(k):
            dxt[s] += dx_ret[s][rows[s, :, j]]
            dtp[s, :, j] = (g3[s] * y_ret[s][rows[s, :, j]]).sum(-1)
    return dxt, dtp


def _ret_bufs(st, tensor: str, plan, d: int) -> list:
    """Per-rank return buffers ``tensor`` of a run; a rank that sends no
    rows has none, and gets an empty one."""
    return [st.get(tensor, r) if plan.send_rows(r)
            else torch.zeros((0, d), dtype=torch.float32, device=st.device)
            for r in range(plan.ep)]


def _dw_of(st, suffix: str, plan, w1, w2):
    """(dW1, dW2) of one layer, shaped like ``w1``/``w2``: a rank that
    receives no rows has a zero gradient."""
    dw1 = torch.stack([st.get(f"dW1{suffix}", r) if plan.recv_rows(r)
                       else torch.zeros_like(w1[r])
                       for r in range(plan.ep)])
    dw2 = torch.stack([st.get(f"dW2{suffix}", r) if plan.recv_rows(r)
                       else torch.zeros_like(w2[r])
                       for r in range(plan.ep)])
    return dw1, dw2


def _exec_backward(dc: DroplessConfig, cache: SSCCache, mc,
                   xt, top_p, top_i, w1, w2, g):
    """The fragment's backward: (dxt [T, d], d top_p [T, k], dW1, dW2), all
    fp32 on xt's device; dW1/dW2 shaped like ``w1``/``w2``."""
    T, d = xt.shape
    f, k, ep = mc.d_expert, mc.top_k, dc.ep
    dev = xt.device
    bridge = _bridge_of(dc, top_i, mc)
    _one_row_per_choice(bridge)
    plan = bridge.plan
    cfg = _schedule_cfg(dc, plan, d, f)
    t_loc = T // ep
    g3 = g.float().reshape(ep, t_loc, d)
    tp3 = top_p.float().reshape(ep, t_loc, k)

    # Recompute the saved activations the backward schedule consumes.
    x_src = bridge_dispatch(bridge, xt.reshape(ep, t_loc, d))
    fwd = ex.reference_forward_plan(cfg, x_src, w1, w2)
    dy = _dy_of(bridge, tp3, g3)

    sched = cache.get_or_compile(cfg, "backward",
                                 pipeline=dc.pipeline_spec())
    st = ex.ExecutorState(cfg, dev)
    ex.load_backward_state_plan(cfg, st, fwd, w1, w2, dy)
    ex.execute(sched, st, rng=np.random.default_rng(0))

    dxt, dtp = _token_grads(bridge, _ret_bufs(st, "dx_ret", plan, d),
                            fwd["y_ret"], g3, tp3)
    dw1, dw2 = _dw_of(st, "", plan, w1, w2)
    return dxt.reshape(T, d), dtp.reshape(T, k), dw1, dw2


class _Fragment(torch.autograd.Function):
    """y = Combine(GMM2(SwiGLU(GMM1(Dispatch(xt))))) with ``top_p``
    weights, through the batch's compiled schedules. ``run`` is the
    :class:`_Run` that resolves the config and holds the cache."""

    @staticmethod
    def forward(ctx, xt, top_p, w_in, w_down, top_i, run):
        ti = top_i.cpu().numpy()      # the plan is built on the host
        ctx.run, ctx.top_i = run, ti
        ctx.save_for_backward(xt, top_p, w_in, w_down)
        dc = run.config(ti, "forward")
        w1, w2 = _expert_weights(dc, run.mc, w_in, w_down)
        return _exec_forward(dc, run.cache, run.mc, xt, top_p, ti, w1, w2)

    @staticmethod
    def backward(ctx, g):
        xt, top_p, w_in, w_down = ctx.saved_tensors
        run = ctx.run
        dc = run.config(ctx.top_i, "backward")
        w1, w2 = _expert_weights(dc, run.mc, w_in, w_down)
        dxt, dtp, dw1, dw2 = _exec_backward(dc, run.cache, run.mc, xt,
                                            top_p, ctx.top_i, w1, w2, g)
        return (dxt.to(xt.dtype), dtp.to(top_p.dtype),
                dw1.reshape(w_in.shape).to(w_in.dtype),
                dw2.reshape(w_down.shape).to(w_down.dtype), None, None)


@dataclasses.dataclass
class _Run:
    dc: DroplessConfig
    cache: SSCCache
    mc: object
    live: object = None

    def config(self, top_i, direction: str) -> DroplessConfig:
        return self.live(top_i, self.mc, direction) if self.live \
            else self.dc


def _make_impl(dc: DroplessConfig, cache: SSCCache, live=None, rows=None):
    """Build ``moe_impl(params, x, mc)`` executing plan-sized schedules.

    ``live`` is the online-tuning seam: a host-side callable
    ``live(top_i, mc, direction) -> DroplessConfig`` called on every
    forward and backward with the batch's host ``top_i``; the returned
    config may differ only in the bucket spec and the pipeline. ``None``
    (the training path) pins ``dc``. ``rows``: a :class:`MeshRows`, the
    fragment of a rank of a process mesh, run on the whole batch.
    """

    def moe_impl(params, x, mc):
        b, s, d = x.shape
        top_p, top_i = router_topk(params["router"], x.reshape(b * s, d), mc)
        w_in, w_down = params["w_in"], params["w_down"]
        if rows is not None:
            k = top_p.shape[-1]
            x = rows.whole(x)
            top_p = rows.whole(top_p.reshape(b, s, k))
            with torch.no_grad():
                top_i = rows.whole(top_i.reshape(b, s, k))
            w_in, w_down = (rows.experts(w, mc.e_total)
                            for w in (w_in, w_down))
        B, S = x.shape[:2]
        T = B * S
        if T % dc.ep:
            raise ValueError(f"T={T} tokens not divisible by dropless "
                             f"ep={dc.ep}")
        y = _Fragment.apply(x.reshape(T, d), top_p.reshape(T, -1), w_in,
                            w_down, top_i.reshape(T, -1),
                            _Run(dc, cache, mc, live))
        y = y.to(x.dtype).reshape(B, S, d)
        return y if rows is None else rows.own(y, b, s)

    # _Fragment saves only its inputs and recomputes the rest in its
    # backward, so the model's remat leaves it outside the checkpoint.
    moe_impl.self_remat = True
    return moe_impl


# ---------------------------------------------------------------------------
# Fused K-layer block: one multi-fragment taskflow per direction.
# ---------------------------------------------------------------------------


class FusedDroplessMoE:
    """K >= 2 consecutive dropless MoE layers as one fused taskflow.

    Fragment boundary contract (parallel routers): *every* layer's router
    is evaluated on the block input ``x``, so all K routing plans — and
    therefore the complete multi-fragment taskflow, boundary tiles
    included — are known before the first dispatch launches. Each
    inter-layer token remap (layer j's combine-weighted gather composed
    with layer j+1's send-buffer scatter) is rank-local, so it runs as
    LayerBoundary tiles *inside* the taskflow and layer j+1's dispatch
    traffic overlaps layer j's combine tail.

    ``fuse=False`` keeps the same parallel-router semantics but executes
    the K per-layer schedules back to back with the bridge ops in between
    — the sequential twin the fused path equals bit for bit, forward and
    backward. ``fuse="auto"`` decides per batch and direction through
    ``core.autoselect.select_fused``. ``device`` is where the block runs
    (the card unless the caller asks for the CPU); ``gmm`` replaces the
    GMM tiles' kernel (``kernels.ref.gmm_ref`` gives the plain executor).
    """

    def __init__(self, dc: DroplessConfig, act: str = "swiglu",
                 cache: Optional[SSCCache] = None, fuse=True,
                 device="cuda", gmm=None):
        if act != "swiglu":
            raise ValueError(
                f"dropless schedules execute the SwiGLU fragment; act={act!r}")
        if not (isinstance(fuse, bool) or fuse == "auto"):
            raise ValueError(f'fuse must be True, False or "auto", '
                             f"got {fuse!r}")
        self.dc = dc
        self.fuse = fuse
        self.cache = cache if cache is not None else get_process_cache(
            dc.cache_entries)
        self.impl = _make_fused_impl(dc, self.cache, fuse, device=device,
                                     gmm=gmm)


@dataclasses.dataclass
class _Block:
    """What one fused block call needs besides its tensors."""

    dc: DroplessConfig
    cache: SSCCache
    mc: object
    fuse: object
    gmm: object
    K: int

    def do_fuse(self, cfgs, direction: str) -> bool:
        if isinstance(self.fuse, bool):
            return self.fuse
        from ..core.autoselect import select_fused
        return select_fused(tuple(cfgs), direction=direction).fuse

    def plans(self, tis, d: int, cache=None):
        bs = [_bridge_of(self.dc, ti, self.mc, cache) for ti in tis]
        return bs, [_schedule_cfg(self.dc, b.plan, d, self.mc.d_expert)
                    for b in bs]

    def state(self, cfg, dev, fragment_cfgs=None):
        return ex.ExecutorState(cfg, dev, gmm=self.gmm,
                                fragment_cfgs=fragment_cfgs)

    def forward(self, xt, tps, tis, ws):
        """y [T, d] fp32 of the block: ``tps`` per layer on the device,
        ``tis`` per layer on the host, ``ws`` per layer (w1, w2) fp32."""
        dc, cache, K = self.dc, self.cache, self.K
        T, d = xt.shape
        dev = xt.device
        bs, cfgs = self.plans(tis, d, cache)
        pipe = dc.pipeline_spec()
        x_src = bridge_dispatch(bs[0], xt.reshape(dc.ep, T // dc.ep, d))
        if self.do_fuse(cfgs, "forward"):
            fs = cache.get_or_compile_fused(cfgs, "forward", pipeline=pipe)
            st = self.state(cfgs[0], dev, cfgs)
            fu.load_fused_forward_state(fs, cfgs, st, x_src,
                                        [w1 for w1, _ in ws],
                                        [w2 for _, w2 in ws])
            st.boundary_fns = {
                (j, r): fn for j in range(K - 1)
                for r, fn in fused_boundary_forward(
                    bs[j], bs[j + 1], tps[j], d).items()}
            ex.execute(fs, st, rng=np.random.default_rng(0))
            y_ret = _ret_bufs(st, f"y_ret#L{K - 1}", bs[-1].plan, d)
        else:
            cur = x_src
            for j in range(K):
                sj = cache.get_or_compile(cfgs[j], "forward", pipeline=pipe)
                stj = self.state(cfgs[j], dev)
                ex.load_forward_state_plan(cfgs[j], stj, cur, *ws[j])
                ex.execute(sj, stj, rng=np.random.default_rng(0))
                y_ret = _ret_bufs(stj, "y_ret", bs[j].plan, d)
                if j < K - 1:
                    cur = bridge_dispatch(
                        bs[j + 1], bridge_combine(bs[j], y_ret, tps[j]))
        return bridge_combine(bs[-1], y_ret, tps[-1]).reshape(T, d)

    def backward(self, xt, tps, tis, ws, g):
        """(dx [T, d], d top_p per layer [T, k], (dW1, dW2) per layer), fp32
        on the device: each layer recomputed with
        ``reference_forward_plan``, then the backward schedules walked in
        execution order (the top layer's first)."""
        dc, cache, K, k = self.dc, self.cache, self.K, self.mc.top_k
        T, d = xt.shape
        dev, ep = xt.device, dc.ep
        t_loc = T // ep
        bs, cfgs = self.plans(tis, d)
        for b in bs:
            _one_row_per_choice(b)
        pipe = dc.pipeline_spec()
        g3 = g.float().reshape(ep, t_loc, d)
        tp3s = [tp.float().reshape(ep, t_loc, k) for tp in tps]

        fwds = []
        cur = bridge_dispatch(bs[0], xt.reshape(ep, t_loc, d))
        for j in range(K):
            fwds.append(ex.reference_forward_plan(cfgs[j], cur, *ws[j],
                                                  gmm=self.gmm))
            if j < K - 1:
                cur = bridge_dispatch(
                    bs[j + 1], bridge_combine(bs[j], fwds[j]["y_ret"],
                                              tps[j]))
        dy = _dy_of(bs[-1], tp3s[-1], g3)

        dtps, dws = [None] * K, [None] * K
        g_up = g3
        if self.do_fuse(cfgs, "backward"):
            fs = cache.get_or_compile_fused(cfgs, "backward", pipeline=pipe)
            exec_cfgs = cfgs[::-1]           # the top layer's gradient first
            st = self.state(cfgs[-1], dev, exec_cfgs)
            fu.load_fused_backward_state(
                fs, exec_cfgs, st, dy, fwds[::-1],
                [w1 for w1, _ in ws][::-1], [w2 for _, w2 in ws][::-1])
            # Execution junction e sits between execution positions e and
            # e+1 (layers K-1-e and K-2-e): the physical junction p =
            # K-2-e, whose remap transposes the forward boundary.
            for e in range(K - 1):
                p = K - 2 - e
                for r, fn in fused_boundary_backward(
                        bs[p], bs[p + 1], tps[p], d).items():
                    st.boundary_fns[(e, r)] = fn
            ex.execute(fs, st, rng=np.random.default_rng(0))
            for layer in range(K - 1, -1, -1):
                plan = bs[layer].plan
                g_up, dtps[layer] = _token_grads(
                    bs[layer], _ret_bufs(st, f"dx_ret#L{layer}", plan, d),
                    fwds[layer]["y_ret"], g_up, tp3s[layer])
                dws[layer] = _dw_of(st, f"#L{layer}", plan, *ws[layer])
        else:
            for layer in range(K - 1, -1, -1):
                plan = bs[layer].plan
                sj = cache.get_or_compile(cfgs[layer], "backward",
                                          pipeline=pipe)
                stj = self.state(cfgs[layer], dev)
                ex.load_backward_state_plan(cfgs[layer], stj, fwds[layer],
                                            *ws[layer], dy)
                ex.execute(sj, stj, rng=np.random.default_rng(0))
                g_up, dtps[layer] = _token_grads(
                    bs[layer], _ret_bufs(stj, "dx_ret", plan, d),
                    fwds[layer]["y_ret"], g_up, tp3s[layer])
                dws[layer] = _dw_of(stj, "", plan, *ws[layer])
                if layer > 0:
                    dy = _dy_of(bs[layer - 1], tp3s[layer - 1], g_up)
        return g_up.reshape(T, d), [t.reshape(T, k) for t in dtps], dws


class _FusedBlock(torch.autograd.Function):
    """y of K dropless layers under the parallel-router contract, through
    the batch's fused (or sequential) schedules. The tensors travel as
    ``*args``: K top_p, K top_i, K w_in, then K w_down."""

    @staticmethod
    def forward(ctx, block, xt, *tensors):
        K = block.K
        tps, tis = tensors[:K], tensors[K:2 * K]
        w_ins, w_downs = tensors[2 * K:3 * K], tensors[3 * K:]
        # The plans are built on the host: one copy of every layer's top_i.
        tis_h = list(torch.stack(tis).cpu().numpy())
        ctx.block, ctx.tis = block, tis_h
        ctx.save_for_backward(xt, *tps, *w_ins, *w_downs)
        ws = [_expert_weights(block.dc, block.mc, wi, wd)
              for wi, wd in zip(w_ins, w_downs)]
        return block.forward(xt, tps, tis_h, ws)

    @staticmethod
    def backward(ctx, g):
        block = ctx.block
        K = block.K
        saved = ctx.saved_tensors
        xt, tps = saved[0], saved[1:K + 1]
        w_ins, w_downs = saved[K + 1:2 * K + 1], saved[2 * K + 1:]
        ws = [_expert_weights(block.dc, block.mc, wi, wd)
              for wi, wd in zip(w_ins, w_downs)]
        dxt, dtps, dws = block.backward(xt, tps, ctx.tis, ws, g)
        return (None, dxt.to(xt.dtype),
                *[dt.to(tp.dtype) for dt, tp in zip(dtps, tps)],
                *[None] * K,
                *[dw1.reshape(w.shape).to(w.dtype)
                  for (dw1, _), w in zip(dws, w_ins)],
                *[dw2.reshape(w.shape).to(w.dtype)
                  for (_, dw2), w in zip(dws, w_downs)])


def _make_fused_impl(dc: DroplessConfig, cache: SSCCache, fuse,
                     device="cuda", gmm=None):
    """Build ``block_impl(params, x, mc)`` for a fused K-layer block.

    ``params`` is a sequence of K >= 2 per-layer dicts, each with
    ``router`` / ``w_in`` / ``w_down``; ``x`` must lie on ``device``.
    """
    dev = resolve_device(device)

    def block_impl(params, x, mc):
        params = list(params)
        K = len(params)
        if K < 2:
            raise ValueError(f"FusedDroplessMoE needs >= 2 layers, got {K}")
        if x.device.type != dev.type:
            raise ValueError(f"x lies on {x.device}; this block runs on "
                             f"{dev}")
        if mc.e_total % dc.ep:
            raise ValueError(f"e_total={mc.e_total} not divisible by "
                             f"dropless ep={dc.ep}")
        B, S, d = x.shape
        T = B * S
        if T % dc.ep:
            raise ValueError(f"T={T} tokens not divisible by dropless "
                             f"ep={dc.ep}")
        xt = x.reshape(T, d)
        # Parallel-router contract: every plan derives from the block input.
        tps, tis = zip(*[router_topk(p["router"], xt, mc) for p in params])
        y = _FusedBlock.apply(_Block(dc, cache, mc, fuse, gmm, K), xt,
                              *tps, *tis, *[p["w_in"] for p in params],
                              *[p["w_down"] for p in params])
        return y.to(x.dtype).reshape(B, S, d)

    return block_impl
