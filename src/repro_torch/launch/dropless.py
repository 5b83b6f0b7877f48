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
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import executor as ex
from ..core.odg import ScheduleConfig
from ..core.ssc import SSCCache
from ..models.moe import (bridge_combine, bridge_dispatch, plan_from_routing,
                          router_topk)


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
    """A dropless ``moe_impl`` plus its schedule cache handle."""

    def __init__(self, dc: DroplessConfig, act: str = "swiglu",
                 cache: Optional[SSCCache] = None):
        if act != "swiglu":
            raise ValueError(
                f"dropless schedules execute the SwiGLU fragment; act={act!r}")
        self.dc = dc
        self.cache = cache if cache is not None else get_process_cache(
            dc.cache_entries)
        self.impl = _make_impl(dc, self.cache)
        self._snapshot = self._counters()

    def _counters(self) -> tuple:
        info = self.cache.info()
        return (info["hits"], info["misses"], info["evictions"],
                info["exact_rows"], info["padded_rows"])

    def rescale(self, new_ep: Optional[int] = None,
                dead_ranks=None) -> "DroplessMoE":
        """A fresh impl on a mesh of ``new_ep`` ranks, sharing this handle's
        cache, which is re-keyed for the new mesh (old-mesh entries stay
        resident but bear the LRU pressure first). Rescaling from lost ranks
        (``dead_ranks``) needs ``core.elastic``, which comes with the port's
        fusion/elastic slice."""
        if dead_ranks is not None:
            raise NotImplementedError(
                "rescale(dead_ranks=...) needs core.elastic, which comes "
                "with the port's fusion/elastic slice; pass new_ep=")
        if new_ep is None:
            raise ValueError("pass new_ep=")
        new_ep = int(new_ep)
        if new_ep < 1:
            raise ValueError(f"new_ep must be >= 1, got {new_ep}")
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
                      cache: Optional[SSCCache] = None) -> DroplessMoE:
    """Build the dropless MoE impl for a model config (validates shapes)."""
    mc = model_cfg.moe
    if mc is None:
        raise ValueError("dropless MoE requires a MoE model config")
    if mc.e_total % dc.ep:
        raise ValueError(f"e_total={mc.e_total} not divisible by "
                         f"dropless ep={dc.ep}")
    return DroplessMoE(dc, act=model_cfg.act, cache=cache)


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
    y_ret = [st.get("y_ret", r) if plan.send_rows(r)
             else xt.new_zeros((0, d), dtype=torch.float32)
             for r in range(dc.ep)]
    return bridge_combine(bridge, y_ret, top_p).reshape(T, d)


def _exec_backward(dc: DroplessConfig, cache: SSCCache, mc,
                   xt, top_p, top_i, w1, w2, g):
    """The fragment's backward: (dxt [T, d], d top_p [T, k], dW1, dW2), all
    fp32 on xt's device; dW1/dW2 shaped like ``w1``/``w2``."""
    T, d = xt.shape
    f, k, ep = mc.d_expert, mc.top_k, dc.ep
    dev = xt.device
    bridge = _bridge_of(dc, top_i, mc)
    plan = bridge.plan
    cfg = _schedule_cfg(dc, plan, d, f)
    t_loc = T // ep
    g3 = g.float().reshape(ep, t_loc, d)
    tp3 = top_p.float().reshape(ep, t_loc, k)
    # A dropless choice owns one send row, so the cotangent scatter below
    # is a plain assignment (the reference accumulates with np.add.at).
    for s in range(ep):
        r = bridge.send_row[s]
        if (r < 0).any() or np.unique(r).size != r.size:
            raise AssertionError(f"rank {s}: dropless send rows are not "
                                 f"one per choice")
    rows = bridge.rows_on(dev)                       # [ep, t_loc, k]

    # Recompute the saved activations the backward schedule consumes.
    x_src = bridge_dispatch(bridge, xt.reshape(ep, t_loc, d))
    fwd = ex.reference_forward_plan(cfg, x_src, w1, w2)

    # Per-row cotangent entering the fragment: dy[row] = p · g_token.
    dy = []
    for s in range(ep):
        buf = torch.zeros((plan.send_rows(s), d), dtype=torch.float32,
                          device=dev)
        buf[rows[s]] = tp3[s][:, :, None] * g3[s][:, None, :]
        dy.append(buf)

    sched = cache.get_or_compile(cfg, "backward",
                                 pipeline=dc.pipeline_spec())
    st = ex.ExecutorState(cfg, dev)
    ex.load_backward_state_plan(cfg, st, fwd, w1, w2, dy)
    ex.execute(sched, st, rng=np.random.default_rng(0))

    dxt = torch.zeros((ep, t_loc, d), dtype=torch.float32, device=dev)
    dtp = torch.zeros((ep, t_loc, k), dtype=torch.float32, device=dev)
    for s in range(ep):
        if not plan.send_rows(s):
            continue
        dx_ret = st.get("dx_ret", s)
        y_ret = fwd["y_ret"][s]
        for j in range(k):
            dxt[s] += dx_ret[rows[s, :, j]]
            dtp[s, :, j] = (g3[s] * y_ret[rows[s, :, j]]).sum(-1)
    dw1 = torch.stack([st.get("dW1", r) if plan.recv_rows(r)
                       else torch.zeros_like(w1[r]) for r in range(ep)])
    dw2 = torch.stack([st.get("dW2", r) if plan.recv_rows(r)
                       else torch.zeros_like(w2[r]) for r in range(ep)])
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


def _make_impl(dc: DroplessConfig, cache: SSCCache, live=None):
    """Build ``moe_impl(params, x, mc)`` executing plan-sized schedules.

    ``live`` is the online-tuning seam: a host-side callable
    ``live(top_i, mc, direction) -> DroplessConfig`` called on every
    forward and backward with the batch's host ``top_i``; the returned
    config may differ only in the bucket spec and the pipeline. ``None``
    (the training path) pins ``dc``.
    """

    def moe_impl(params, x, mc):
        B, S, d = x.shape
        T = B * S
        if T % dc.ep:
            raise ValueError(f"T={T} tokens not divisible by dropless "
                             f"ep={dc.ep}")
        xt = x.reshape(T, d)
        top_p, top_i = router_topk(params["router"], xt, mc)
        y = _Fragment.apply(xt, top_p, params["w_in"], params["w_down"],
                            top_i, _Run(dc, cache, mc, live))
        return y.to(x.dtype).reshape(B, S, d)

    return moe_impl
