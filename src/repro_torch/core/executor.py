"""Numerical executor for compiled schedules — counterpart of
``repro.core.executor``, on torch tensors.

Replays an SSC taskflow *with real numbers* over an in-process model of the
EP group: every buffer is a ``[rows, width]`` fp32 tensor per (tensor,
rank) on the state's device, comm tasks perform one-sided writes into the
destination rank's buffer (device copies: the ranks are virtual, one
process and one device hold them all), and tasks run in an arbitrary legal
order chosen by the event counters — the runtime protocol of §4.4. The
queue walk, and its ``numpy.random.Generator`` pick among ready queue heads,
are the reference's, so one seed gives the reference's task order.

GMM and GMMWGrad tiles run ``ExecutorState.gmm``: the port's ``gmm`` kernel
by default (on a CPU tensor its plain version), ``kernels.ref.gmm_ref`` for
the plain executor the card's checks compare against. SwiGLU tiles are
plain torch ops, with the reference's formulas. The handlers read only
host-side integers (task ranges, plan offsets), so a walk over the tasks
never waits on the device.

The ``*_plan`` references run the per-expert products through the same
``gmm`` calls the tiles make, so at ``gmm_m_split=1`` the executor equals
them bit for bit; ``reference_backward_plan_autograd`` is an independent
``torch.autograd`` oracle (the reference uses ``jax.vjp``).

Multi-fragment schedules (``core/fusion``): every handler resolves
routing through ``ExecutorState.cfg_of`` (the fragment's own plan), and
LayerBoundary/StageBoundary tiles call the per-(junction, rank)
``boundary_fns`` — on the card the dropless remaps of ``models/moe.py``,
which work on device tensors — or copy rows when none is registered.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.gmm import gmm as gmm_kernel
from ..parallel.compression import int8_roundtrip
from .odg import ScheduleConfig
from .scheduler import Schedule, ScheduleError
from .tasks import NO_EVENT, TaskDescriptor


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


def swiglu(h):
    """silu(h[..., :f]) · h[..., f:] — ``swiglu_np``'s formula."""
    f = h.shape[-1] // 2
    a = h[..., :f]
    return a * _sigmoid(a) * h[..., f:]


def swiglu_grad(dg, h):
    """d(swiglu)/dh against cotangent ``dg`` — ``swiglu_grad_np``'s formula.
    """
    f = h.shape[-1] // 2
    a, b = h[..., :f], h[..., f:]
    s = _sigmoid(a)
    silu_a = a * s
    dsilu = s * (1.0 + a * (1.0 - s))
    return torch.cat([dg * b * dsilu, dg * silu_a], dim=-1)


def _mm(gmm, a, w, ta: bool = False, tw: bool = False):
    """One [rows, K] × [K, N] product through a grouped-GEMM call with E = 1;
    ``ta``/``tw`` pass a or w as its transposed view (no copy)."""
    a, w = a[None], w[None]
    return gmm(a.transpose(1, 2) if ta else a,
               w.transpose(1, 2) if tw else w)[0]


class ExecutorState:
    """All (tensor, rank) buffers of one EP group, on one device: the card
    unless the caller asks for the CPU (``device="cpu"``)."""

    def __init__(self, cfg: ScheduleConfig, device="cuda",
                 gmm: Optional[Callable] = None,
                 fragment_cfgs: Optional[list[ScheduleConfig]] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.gmm = gmm or gmm_kernel
        self.buffers: dict[tuple[str, int], torch.Tensor] = {}
        self.weights: dict[tuple[str, int], torch.Tensor] = {}
        # (tensor, rank) -> total rows, precomputed from the schedule's write
        # set so lazily-created buffers get their full extent up front.
        self.rows_map: dict[tuple[str, int], int] = {}
        # Multi-fragment schedules: per-fragment configs in execution order
        # (each fragment's tasks must resolve routing against *its* plan).
        self.fragment_cfgs = fragment_cfgs
        # (junction index, rank) -> fn(full_input|None, lo, hi) -> [hi-lo, w]
        # tensor on this state's device: the numerical remap of
        # LayerBoundary/StageBoundary tiles; identity when absent.
        self.boundary_fns: dict[tuple[int, int], Callable] = {}

    def cfg_of(self, td: TaskDescriptor) -> ScheduleConfig:
        """The config governing this task's routing extents."""
        if self.fragment_cfgs is not None:
            return self.fragment_cfgs[td.meta.get("fragment", 0)]
        return self.cfg

    def _tensor(self, arr):
        return torch.as_tensor(arr, dtype=torch.float32, device=self.device)

    def set_buffer(self, name: str, rank: int, arr) -> None:
        self.buffers[(name, rank)] = self._tensor(arr)

    def set_weight(self, name: str, rank: int, arr) -> None:
        """Weights are [e_loc, K, N] per rank."""
        self.weights[(name, rank)] = self._tensor(arr)

    def ensure(self, name: str, rank: int, rows: int,
               width: int) -> torch.Tensor:
        """Lazily create a buffer, sized strictly from the schedule's
        precomputed ``rows_map``."""
        key = (name, rank)
        if key not in self.buffers:
            rows = max(rows, self.rows_map.get(key, 0))
            self.buffers[key] = torch.zeros((rows, width),
                                            dtype=torch.float32,
                                            device=self.device)
        return self.buffers[key]

    def get(self, name: str, rank: int) -> torch.Tensor:
        if (name, rank) in self.buffers:
            return self.buffers[(name, rank)]
        return self.weights[(name, rank)]


# ---------------------------------------------------------------------------
# Task handlers — bridge TDs to "operator bodies" (§4.4's handler layer).
# ---------------------------------------------------------------------------

def _h_put_mem_signal(td: TaskDescriptor, st: ExecutorState) -> None:
    src = td.inputs[0]
    data = st.get(src.tensor, src.rank)[src.lo:src.hi]
    if td.meta.get("compress") == "int8":
        # Compressed inter-node hop: the destination receives the
        # quantize→dequantize round-trip of the payload.
        data = int8_roundtrip(data)
    off = 0
    for out in td.outputs:
        buf = st.ensure(out.tensor, out.rank, out.hi, data.shape[1])
        n = out.hi - out.lo
        buf[out.lo:out.hi] = data[off:off + n]
        off += n


def _check_tile(td: TaskDescriptor, rng) -> None:
    if rng.hi < rng.lo:
        raise ScheduleError(f"{td.op_name}: empty-reversed tile "
                            f"[{rng.lo}, {rng.hi}) of {rng.tensor}")


def _h_gmm(td: TaskDescriptor, st: ExecutorState) -> None:
    a_rng, w_rng = td.inputs
    a = st.get(a_rng.tensor, a_rng.rank)[a_rng.lo:a_rng.hi]
    w_all = st.get(w_rng.tensor, w_rng.rank)
    # Activation-gradient GMMs multiply by Wᵀ: a transposed view.
    tw = td.meta.get("which") in ("act_grad", "gate_grad")
    if td.meta.get("fallback"):
        # Unsplit task: block-diagonal GMM over the plan's expert blocks
        # (ragged extents; empty experts contribute no rows).
        cfg = st.cfg_of(td)
        plan = cfg.routing
        r = td.rank
        outs = []
        for e in range(cfg.e_loc):
            rows_e = plan.expert_rows(r, e)
            if rows_e == 0:
                continue
            lo = plan.expert_offset(r, e)
            outs.append(_mm(st.gmm, a[lo:lo + rows_e], w_all[e], tw=tw))
        out = torch.cat(outs, dim=0)
    else:
        _check_tile(td, a_rng)
        out = _mm(st.gmm, a, w_all[w_rng.lo], tw=tw)
    o = td.outputs[0]
    buf = st.ensure(o.tensor, o.rank, o.hi, out.shape[1])
    if buf.shape[0] < o.hi:
        raise ScheduleError(f"output buffer too small for {td.op_name}")
    buf[o.lo:o.hi] = out


def _h_gmm_wgrad(td: TaskDescriptor, st: ExecutorState) -> None:
    g_rng, act_rng = td.inputs   # [grad rows, saved activation rows]
    grad = st.get(g_rng.tensor, g_rng.rank)[g_rng.lo:g_rng.hi]
    act = st.get(act_rng.tensor, act_rng.rank)[act_rng.lo:act_rng.hi]
    key = (td.outputs[0].tensor, td.outputs[0].rank)
    cfg = st.cfg_of(td)
    if key not in st.buffers:
        st.buffers[key] = torch.zeros(
            (cfg.e_loc, act.shape[1], grad.shape[1]), dtype=torch.float32,
            device=st.device)
    if td.meta.get("fallback"):
        plan = cfg.routing
        r = td.rank
        for e in range(cfg.e_loc):
            rows_e = plan.expert_rows(r, e)
            if rows_e == 0:
                continue      # no routed rows → zero gradient contribution
            lo = plan.expert_offset(r, e)
            st.buffers[key][e] += _mm(st.gmm, act[lo:lo + rows_e],
                                      grad[lo:lo + rows_e], ta=True)
        return
    _check_tile(td, g_rng)
    if act.shape[0]:             # m-chunks of one expert accumulate
        st.buffers[key][td.outputs[0].lo] += _mm(st.gmm, act, grad, ta=True)


def _h_swiglu(td: TaskDescriptor, st: ExecutorState) -> None:
    i = td.inputs[0]
    out = swiglu(st.get(i.tensor, i.rank)[i.lo:i.hi])
    o = td.outputs[0]
    buf = st.ensure(o.tensor, o.rank, o.hi, out.shape[1])
    buf[o.lo:o.hi] = out


def _h_swiglu_grad(td: TaskDescriptor, st: ExecutorState) -> None:
    dg_rng, h_rng = td.inputs
    dg = st.get(dg_rng.tensor, dg_rng.rank)[dg_rng.lo:dg_rng.hi]
    h = st.get(h_rng.tensor, h_rng.rank)[h_rng.lo:h_rng.hi]
    out = swiglu_grad(dg, h)
    o = td.outputs[0]
    buf = st.ensure(o.tensor, o.rank, o.hi, out.shape[1])
    buf[o.lo:o.hi] = out


def _h_layer_boundary(td: TaskDescriptor, st: ExecutorState) -> None:
    """Inter-layer token remap tile of a fused multi-fragment schedule.

    The numerical remap (upstream combine-weighted sum composed with the
    downstream layer's routing) lives outside the schedulable fragment;
    ``st.boundary_fns[(junction, rank)]`` supplies it with the contract
    ``fn(full_input_or_None, lo, hi) -> [hi - lo, width]`` where the row
    range addresses the downstream send buffer; the result is held as an
    fp32 tensor on the state's device. Without a registered fn the tile is
    an identity row copy (legal only when the upstream return buffer
    covers the downstream send rows — e.g. both layers share a plan).
    """
    if td.inputs:
        i = td.inputs[0]
        data = st.get(i.tensor, i.rank)[i.lo:i.hi]
    else:
        data = None              # rank returned no rows upstream
    o = td.outputs[0]
    fn = st.boundary_fns.get((td.meta.get("boundary", 0), td.rank))
    if fn is None:
        if data is None or data.shape[0] < o.hi:
            raise ScheduleError(
                f"{td.op_name}: identity boundary needs {o.hi} upstream "
                f"rows, have {0 if data is None else data.shape[0]}; "
                f"register a boundary_fn for mismatched plans")
        out = data[o.lo:o.hi]
    else:
        out = st._tensor(fn(data, o.lo, o.hi))
    if out.shape[0] != o.hi - o.lo:
        raise ScheduleError(
            f"{td.op_name}: boundary fn returned {out.shape[0]} rows "
            f"for range [{o.lo}, {o.hi})")
    buf = st.ensure(o.tensor, o.rank, o.hi, out.shape[1])
    buf[o.lo:o.hi] = out


HANDLERS: dict[str, Callable[[TaskDescriptor, ExecutorState], None]] = {
    "put_mem_signal": _h_put_mem_signal,
    "GMM": _h_gmm,
    "GMMWGrad": _h_gmm_wgrad,
    "SwiGLU": _h_swiglu,
    "SwiGLUGrad": _h_swiglu_grad,
    "LayerBoundary": _h_layer_boundary,
    # The PP stage handoff computes the same junction remap; only its
    # scheduling and pricing differ (activation payload over the stage
    # link), so it shares the handler and the ``boundary_fns`` keys.
    "StageBoundary": _h_layer_boundary,
}


def execute(sched: Schedule, st: ExecutorState,
            rng: Optional[np.random.Generator] = None,
            record_order: Optional[list[int]] = None) -> None:
    """Run the taskflow under event-counter gating.

    Among all currently-runnable queue heads, picks uniformly at random when
    ``rng`` is given (adversarial order), else round-robin — results must be
    identical either way.
    """
    for td in sched.tasks:
        for w in td.outputs:
            key = (w.tensor, w.rank)
            st.rows_map[key] = max(st.rows_map.get(key, 0), w.hi)
    cursors = {k: 0 for k in sched.queues}
    counters: dict[int, int] = defaultdict(int)
    done = 0
    keys = sorted(sched.queues.keys())
    while done < sched.n_tasks:
        ready = []
        for key in keys:
            q = sched.queues[key]
            c = cursors[key]
            if c >= len(q):
                continue
            td = sched.tasks[q[c]]
            if (td.dependent_event == NO_EVENT
                    or counters[td.dependent_event] >= td.dependent_threshold):
                ready.append(key)
        if not ready:
            raise ScheduleError(f"runtime deadlock at {done}/{sched.n_tasks}")
        if rng is not None:
            chosen = [ready[rng.integers(len(ready))]]
        else:
            chosen = ready
        for key in chosen:
            q = sched.queues[key]
            td = sched.tasks[q[cursors[key]]]
            HANDLERS[td.task_type](td, st)
            if td.trigger_event != NO_EVENT:
                counters[td.trigger_event] += 1
            cursors[key] += 1
            done += 1
            if record_order is not None:
                record_order.append(td.tid)


# ---------------------------------------------------------------------------
# Monolithic references (what a kernel-by-kernel framework computes).
# ---------------------------------------------------------------------------

def make_inputs(cfg: ScheduleConfig, seed: int = 0, device="cuda"):
    """Balanced-routing fragment inputs: x_src per rank, W1/W2 per rank —
    the reference's numpy draws, as fp32 tensors on ``device`` (the card
    unless the caller asks for the CPU)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    d, f = cfg.d_model, cfg.d_ff
    x_src = rng.standard_normal(
        (cfg.ep, cfg.ep * cfg.e_loc * cfg.rows, d)).astype(np.float32)
    # Scale before the float32 cast, as the reference does.
    w1 = (rng.standard_normal((cfg.ep, cfg.e_loc, d, 2 * f))
          / np.sqrt(d)).astype(np.float32)
    w2 = (rng.standard_normal((cfg.ep, cfg.e_loc, f, d))
          / np.sqrt(f)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (x_src, w1, w2))


def _balanced_fragment(cfg: ScheduleConfig, x_src, w1, w2) -> dict:
    ep, el, R = cfg.ep, cfg.e_loc, cfg.rows
    d, f = cfg.d_model, cfg.d_ff
    # Dispatch: x_src[s] grouped by (dst, e) → x_recv[r] grouped by (e, src).
    blocks = x_src.reshape(ep, ep, el, R, d)          # [src, dst, e, R, d]
    x_flat = blocks.permute(1, 2, 0, 3, 4).reshape(ep, el, ep * R, d)
    h = torch.einsum("repd,redf->repf", x_flat, w1)
    g = swiglu(h)
    y = torch.einsum("repf,refd->repd", g, w2)
    # Combine: y[r] grouped by (e, src) → y_ret[s] grouped by (dst=r, e).
    y_ret = y.reshape(ep, el, ep, R, d).permute(2, 0, 1, 3, 4)
    return {
        "x_recv": x_flat.reshape(ep, el * ep * R, d),
        "h": h.reshape(ep, el * ep * R, 2 * f),
        "g": g.reshape(ep, el * ep * R, f),
        "y": y.reshape(ep, el * ep * R, d),
        "y_ret": y_ret.reshape(ep, ep * el * R, d),
    }


def reference_forward(cfg: ScheduleConfig, x_src, w1, w2) -> dict:
    """Monolithic Dispatch→GMM1→SwiGLU→GMM2→Combine, all ranks at once."""
    with torch.no_grad():
        return _balanced_fragment(cfg, x_src, w1, w2)


def reference_backward(cfg: ScheduleConfig, x_src, w1, w2, dy):
    """Reference gradients by ``torch.autograd`` of the monolithic fragment.
    """
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x_src, w1, w2)]
    with torch.enable_grad():
        y = _balanced_fragment(cfg, *leaves)["y_ret"]
        return torch.autograd.grad(y, leaves, dy)


def load_forward_state(cfg: ScheduleConfig, st: ExecutorState,
                       x_src, w1, w2) -> None:
    for r in range(cfg.ep):
        st.set_buffer("x_src", r, x_src[r])
        st.set_weight("W1", r, w1[r])
        st.set_weight("W2", r, w2[r])


def load_backward_state(cfg: ScheduleConfig, st: ExecutorState,
                        fwd: dict, w1, w2, dy) -> None:
    for r in range(cfg.ep):
        st.set_buffer("dy_src", r, dy[r])
        st.set_weight("W1", r, w1[r])
        st.set_weight("W2", r, w2[r])
        st.set_buffer("g_saved", r, fwd["g"][r])
        st.set_buffer("h_saved", r, fwd["h"][r])
        st.set_buffer("x_recv_saved", r, fwd["x_recv"][r])


# ---------------------------------------------------------------------------
# Ragged (plan-aware) references — imbalanced routing. Per-rank buffers have
# different row counts under a RoutingPlan, so these work with per-rank
# lists of [rows_r, width] tensors.
# ---------------------------------------------------------------------------

def make_inputs_plan(cfg: ScheduleConfig, seed: int = 0, device="cuda"):
    """Ragged fragment inputs: per-rank x_src list, W1/W2 per rank — the
    reference's numpy draws, as fp32 tensors on ``device`` (the card unless
    the caller asks for the CPU)."""
    device = resolve_device(device)
    plan = cfg.routing
    rng = np.random.default_rng(seed)
    d, f = cfg.d_model, cfg.d_ff
    x_src = [rng.standard_normal((plan.send_rows(r), d)).astype(np.float32)
             for r in range(cfg.ep)]
    w1 = (rng.standard_normal((cfg.ep, cfg.e_loc, d, 2 * f))
          / np.sqrt(d)).astype(np.float32)
    w2 = (rng.standard_normal((cfg.ep, cfg.e_loc, f, d))
          / np.sqrt(f)).astype(np.float32)
    return ([torch.from_numpy(x).to(device) for x in x_src],
            torch.from_numpy(w1).to(device), torch.from_numpy(w2).to(device))


def _dispatch(plan, src_bufs: list, width: int) -> list:
    """(dst, expert)-major send layout → (expert, src)-major recv layout."""
    dev = src_bufs[0].device
    recv = []
    for r in range(plan.ep):
        buf = torch.zeros((plan.recv_rows(r), width), dtype=torch.float32,
                          device=dev)
        for (e, s, c) in plan.recv_layout_cells(r):
            lo = plan.recv_offset(r, e, s)
            s_lo = plan.send_offset(s, r, e)
            buf[lo:lo + c] = src_bufs[s][s_lo:s_lo + c]
        recv.append(buf)
    return recv


def _combine(plan, y_bufs: list, width: int) -> list:
    """(expert, src)-major recv layout → send layout on each source rank."""
    dev = y_bufs[0].device
    ret = []
    for s in range(plan.ep):
        buf = torch.zeros((plan.send_rows(s), width), dtype=torch.float32,
                          device=dev)
        for (d, e, c) in plan.send_cells(s):
            lo = plan.send_offset(s, d, e)
            y_lo = plan.recv_offset(d, e, s)
            buf[lo:lo + c] = y_bufs[d][y_lo:y_lo + c]
        ret.append(buf)
    return ret


def reference_forward_plan(cfg: ScheduleConfig, x_src, w1, w2,
                           gmm: Optional[Callable] = None) -> dict:
    """Ragged Dispatch→GMM1→SwiGLU→GMM2→Combine; all values per-rank lists.
    One ``gmm`` call per expert block and product, as the executor's
    ``gmm_m_split=1`` tiles make them."""
    gmm = gmm or gmm_kernel
    plan = cfg.routing
    d, f = cfg.d_model, cfg.d_ff
    x_recv = _dispatch(plan, x_src, d)
    dev = x_recv[0].device
    h, g, y = [], [], []
    for r in range(cfg.ep):
        n = plan.recv_rows(r)
        h_r = torch.zeros((n, 2 * f), dtype=torch.float32, device=dev)
        g_r = torch.zeros((n, f), dtype=torch.float32, device=dev)
        y_r = torch.zeros((n, d), dtype=torch.float32, device=dev)
        for e in range(cfg.e_loc):
            rows_e = plan.expert_rows(r, e)
            if rows_e == 0:
                continue
            sl = slice(plan.expert_offset(r, e),
                       plan.expert_offset(r, e) + rows_e)
            h_r[sl] = _mm(gmm, x_recv[r][sl], w1[r, e])
            g_r[sl] = swiglu(h_r[sl])
            y_r[sl] = _mm(gmm, g_r[sl], w2[r, e])
        h.append(h_r)
        g.append(g_r)
        y.append(y_r)
    y_ret = _combine(plan, y, d)
    return {"x_recv": x_recv, "h": h, "g": g, "y": y, "y_ret": y_ret}


def reference_backward_plan(cfg: ScheduleConfig, fwd: dict, w1, w2, dy,
                            gmm: Optional[Callable] = None):
    """Manual ragged backward mirroring the executor's per-expert products.

    Returns (dx_ret list, dW1 [ep, e_loc, d, 2f], dW2 [ep, e_loc, f, d]).
    Bit-identical to the executor at gmm_m_split=1 by construction; use
    :func:`reference_backward_plan_autograd` for an independent oracle.
    """
    gmm = gmm or gmm_kernel
    plan = cfg.routing
    d = cfg.d_model
    dy_recv = _dispatch(plan, dy, d)
    dW1 = torch.zeros_like(w1)
    dW2 = torch.zeros_like(w2)
    dx_disp = []
    for r in range(cfg.ep):
        dx_r = torch.zeros((plan.recv_rows(r), d), dtype=torch.float32,
                           device=w1.device)
        for e in range(cfg.e_loc):
            rows_e = plan.expert_rows(r, e)
            if rows_e == 0:
                continue
            lo = plan.expert_offset(r, e)
            sl = slice(lo, lo + rows_e)
            dg = _mm(gmm, dy_recv[r][sl], w2[r, e], tw=True)
            dW2[r, e] = _mm(gmm, fwd["g"][r][sl], dy_recv[r][sl], ta=True)
            dh = swiglu_grad(dg, fwd["h"][r][sl])
            dx_r[sl] = _mm(gmm, dh, w1[r, e], tw=True)
            dW1[r, e] = _mm(gmm, fwd["x_recv"][r][sl], dh, ta=True)
        dx_disp.append(dx_r)
    dx_ret = _combine(plan, dx_disp, d)
    return dx_ret, dW1, dW2


def plain_fragment_plan(cfg: ScheduleConfig, x_src, w1, w2) -> list:
    """The ragged fragment in differentiable torch ops (``torch.matmul``),
    per-rank ``y_ret`` list: the plain version autograd differentiates."""
    plan = cfg.routing
    d, f = cfg.d_model, cfg.d_ff
    empty = x_src[0].new_zeros((0, d))
    x_recv = []
    for r in range(cfg.ep):
        blocks = [x_src[s][plan.send_offset(s, r, e):
                           plan.send_offset(s, r, e) + c]
                  for (e, s, c) in plan.recv_layout_cells(r)]
        x_recv.append(torch.cat(blocks, dim=0) if blocks else empty)
    ys = []
    for r in range(cfg.ep):
        parts = []
        for e in range(cfg.e_loc):
            rows_e = plan.expert_rows(r, e)
            if rows_e == 0:
                continue
            lo = plan.expert_offset(r, e)
            h = x_recv[r][lo:lo + rows_e] @ w1[r, e]
            a, b = h[:, :f], h[:, f:]
            parts.append((torch.nn.functional.silu(a) * b) @ w2[r, e])
        ys.append(torch.cat(parts, dim=0) if parts else empty)
    y_ret = []
    for s in range(cfg.ep):
        blocks = [ys[dd][plan.recv_offset(dd, e, s):
                         plan.recv_offset(dd, e, s) + c]
                  for (dd, e, c) in plan.send_cells(s)]
        y_ret.append(torch.cat(blocks, dim=0) if blocks else empty)
    return y_ret


def reference_backward_plan_autograd(cfg: ScheduleConfig, x_src, w1, w2,
                                     dy):
    """Independent oracle: ``torch.autograd`` over
    :func:`plain_fragment_plan`. Returns (dx list, dW1, dW2)."""
    xs = [x.detach().clone().requires_grad_(True) for x in x_src]
    w1 = w1.detach().clone().requires_grad_(True)
    w2 = w2.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        ys = plain_fragment_plan(cfg, xs, w1, w2)
        pairs = [(y, g) for y, g in zip(ys, dy) if y.numel()]
        grads = torch.autograd.grad([y for y, _ in pairs],
                                    xs + [w1, w2],
                                    [g for _, g in pairs],
                                    allow_unused=True)
    dx = [torch.zeros_like(x) if g is None else g
          for x, g in zip(xs, grads[:len(xs)])]
    return dx, grads[-2], grads[-1]


def load_forward_state_plan(cfg: ScheduleConfig, st: ExecutorState,
                            x_src, w1, w2) -> None:
    for r in range(cfg.ep):
        st.set_buffer("x_src", r, x_src[r])
        st.set_weight("W1", r, w1[r])
        st.set_weight("W2", r, w2[r])


def load_backward_state_plan(cfg: ScheduleConfig, st: ExecutorState,
                             fwd: dict, w1, w2, dy) -> None:
    for r in range(cfg.ep):
        st.set_buffer("dy_src", r, dy[r])
        st.set_weight("W1", r, w1[r])
        st.set_weight("W2", r, w2[r])
        st.set_buffer("g_saved", r, fwd["g"][r])
        st.set_buffer("h_saved", r, fwd["h"][r])
        st.set_buffer("x_recv_saved", r, fwd["x_recv"][r])
