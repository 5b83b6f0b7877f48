"""One dropless MoE layer's Dispatch → GMM1 → SwiGLU → GMM2 → Combine
fragment beside the fixed-capacity ``moe_grouped`` on the same routed batch.

The JAX package's ``benchmarks/bench_dropless.py`` measures the schedule
cache (recompile rate, padded rows) on synthetic traffic; this script
measures what the port adds: the fragment itself on the card.

On the card (the default), one granite-moe-3b-a800m layer at full width
(d 1536, 48 experts of F = 512, top-8) on T = 4096 tokens, random weights
from the seed, routed by the layer's own router, at ep = 1 and ep = 4
(virtual ranks on the one card; their puts are device copies, not a
collective):
    PYTHONPATH=src python -m repro_torch.launch.bench_dropless
On the CPU, at the smoke config's widths and without times:
    PYTHONPATH=src python -m repro_torch.launch.bench_dropless \\
        --device cpu --smoke --tokens 64

Each ep is first held, in fp32:

* the forward ``y`` against the plain executor (the same schedule with
  ``kernels.ref.gmm_ref`` tiles), within ``TOL_PLAIN``;
* ``y`` against the fixed-capacity ``moe_grouped`` through the kernels at a
  capacity that drops nothing, within ``TOL_FIXED``;
* dx, d top_p, dW1 and dW2 against ``torch.autograd`` of the plain
  fragment (``core.executor.plain_fragment_plan``), within ``TOL_GRAD``;
* the backward's recompute (``reference_forward_plan``) bit-equal to the
  forward's executor buffers.

Then timed on the card with the training path's inputs (bf16 x and weights,
cast to fp32 inside the fragment as in training), host clock around calls
that end in ``synchronize``, median of ``REPS`` after ``WARMUP``: the
fragment's forward on a cache hit (``_Fragment`` as the model calls it:
top_i to the host, plan, cache, dispatch, the walk, combine) and its
backward, compile ms on a miss, tasks per direction and ``gmm`` launches
per call; and the fixed-capacity bf16 ``moe_grouped`` forward and backward
through ``gmm_swiglu`` / ``gmm`` / ``gmm_swiglu_bwd`` at its training
capacity (C = 854 at full width). Beside each host time, the device's busy
ms in one traced call (``busy_ms``): the rest is the host's.
"""

from __future__ import annotations

import argparse
import statistics
import time
from functools import partial

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..core import executor as ex
from ..core.ssc import SSCCache
from ..device import resolve_device
from ..kernels import gmm as gmm_kernel
from ..kernels import ops
from ..kernels.ref import gmm_ref
from ..models.moe import (bridge_combine, bridge_dispatch, capacity,
                          init_moe, moe_grouped, router_topk)
from . import dropless as D

ARCH = "granite-moe-3b-a800m"
TOKENS = 4096
EPS = (1, 4)
WARMUP, REPS = 2, 5
# fp32 tolerances, elementwise |got - want| <= tol + tol·|want|. The plain
# executor makes the same products with another summation order (cuBLAS vs
# the FMA body); moe_grouped adds its own dispatch and combine; the grads
# come from autograd through other products.
TOL_PLAIN, TOL_FIXED, TOL_GRAD = 1e-5, 1e-4, 1e-4


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_ms(fn, dev, reps: int = REPS, warmup: int = WARMUP) -> float:
    """Median host-clock ms of ``fn()``, each call ended by a synchronize."""
    for _ in range(warmup):
        fn()
    _sync(dev)
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        _sync(dev)
        out.append(1e3 * (time.perf_counter() - t))
    return statistics.median(out)


def busy_ms(fn, dev) -> float:
    """Device busy ms of one ``fn()``: the sum of its kernel times in a
    ``torch.profiler`` trace (one stream, so kernels do not overlap)."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(dev)
    return sum(float(e.self_device_time_total) for e in prof.key_averages()
               if "CUDA" in str(getattr(e, "device_type", ""))) / 1e3


def layer(cfg, tokens: int, seed: int, dev):
    """One MoE layer's fp32 params and x [1, tokens, d], from ``seed``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_moe(gen, cfg.d_model, cfg.moe)
    x = torch.randn((1, tokens, cfg.d_model), generator=gen, device=dev)
    return params, x


def _close(name, got, want, tol) -> float:
    err = (got.float() - want.float()).abs()
    if tuple(got.shape) != tuple(want.shape) or not bool(
            (err <= tol + tol * want.float().abs()).all()):
        raise AssertionError(f"dropless {name}: max |err| "
                             f"{float(err.max())} beyond {tol}")
    return float(err.max())


def check(params, x, mc, dc) -> dict:
    """The fragment's forward and backward held four ways (fp32); returns
    the max |err| of each."""
    T, d = x.shape[1], x.shape[2]
    xt = x.reshape(T, d)
    top_p, top_i = router_topk(params["router"], xt, mc)
    ti = top_i.cpu().numpy()
    w1, w2 = D._expert_weights(dc, mc, params["w_in"], params["w_down"])
    cache = SSCCache()
    bridge = D._bridge_of(dc, ti, mc)
    cfg = D._schedule_cfg(dc, bridge.plan, d, mc.d_expert)
    sched = cache.get_or_compile(cfg, "forward", pipeline=dc.pipeline_spec())
    x_src = bridge_dispatch(bridge, xt.reshape(dc.ep, T // dc.ep, d))
    states = {}
    for name, gmm in (("kernel", None), ("plain", gmm_ref)):
        st = ex.ExecutorState(cfg, x.device, gmm=gmm)
        ex.load_forward_state_plan(cfg, st, x_src, w1, w2)
        ex.execute(sched, st, rng=np.random.default_rng(0))
        states[name] = st

    def y_of(st):        # every rank sends: dropless keeps all T·k choices
        return bridge_combine(bridge, [st.get("y_ret", r)
                                       for r in range(dc.ep)],
                              top_p).reshape(T, d)

    y = y_of(states["kernel"])
    out = {"plain_executor": _close("y vs the plain executor", y,
                                    y_of(states["plain"]), TOL_PLAIN)}
    y_api = D._exec_forward(dc, cache, mc, xt, top_p, ti, w1, w2)
    if not torch.equal(y_api, y):
        raise AssertionError("dropless: _exec_forward differs from the "
                             "executor it runs")
    cap = int(np.bincount(ti.reshape(-1), minlength=mc.e_total).max())
    fixed = moe_grouped(params, x, mc, cap=cap, gmm_fn=ops.moe_expert_ffn)
    out["fixed_capacity"] = _close("y vs fixed-capacity moe_grouped", y,
                                   fixed.reshape(T, d), TOL_FIXED)
    out["fixed_capacity_C"] = cap
    rec = ex.reference_forward_plan(cfg, x_src, w1, w2)
    st = states["kernel"]
    out["recompute_bit_equal"] = all(
        torch.equal(rec[n][r], st.get(n, r)) for r in range(dc.ep)
        if bridge.plan.recv_rows(r) for n in ("x_recv", "h", "g", "y"))
    if not out["recompute_bit_equal"]:
        raise AssertionError("dropless: the backward's recompute differs "
                             "from the forward")

    g = torch.randn((T, d), generator=torch.Generator(
        device=x.device).manual_seed(7), device=x.device)
    got = D._exec_backward(dc, cache, mc, xt, top_p, ti, w1, w2, g)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (xt, top_p, w1, w2)]
    with torch.enable_grad():
        xs = bridge_dispatch(bridge, leaves[0].reshape(dc.ep, T // dc.ep,
                                                       d))
        y_ret = ex.plain_fragment_plan(cfg, xs, leaves[2], leaves[3])
        y_plain = bridge_combine(bridge, y_ret, leaves[1]).reshape(T, d)
        want = torch.autograd.grad(y_plain, leaves, g)
    for name, a, b in zip(("dx", "d_top_p", "dW1", "dW2"), got, want):
        out[name] = _close(f"{name} vs autograd of the plain fragment", a,
                           b, TOL_GRAD)
    out["tasks"] = {"forward": sched.n_tasks,
                    "backward": cache.get_or_compile(
                        cfg, "backward",
                        pipeline=dc.pipeline_spec()).n_tasks}
    return out


def timed(params, x, mc, dc, dev) -> dict:
    """Card times of the fragment (bf16 inputs, as training passes them)."""
    T, d = x.shape[1], x.shape[2]
    pb = {k: v.to(torch.bfloat16) if k != "router" else v
          for k, v in params.items()}
    xt = x.reshape(T, d).to(torch.bfloat16)
    top_p, top_i = router_topk(pb["router"], xt, mc)
    ti = top_i.cpu().numpy()
    out = {}
    # Compile on a miss: a fresh cache each time, plan built outside.
    bridge = D._bridge_of(dc, ti, mc)
    cfg = D._schedule_cfg(dc, bridge.plan, d, mc.d_expert)
    for direction in ("forward", "backward"):
        out[f"compile_{direction}_ms"] = host_ms(
            lambda: SSCCache().get_or_compile(
                cfg, direction, pipeline=dc.pipeline_spec()), dev, 3, 1)
    out["plan_ms"] = host_ms(lambda: D._bridge_of(dc, ti, mc), dev)
    cache = SSCCache()
    run = D._Run(dc, cache, mc)

    def fwd():
        with torch.no_grad():
            return D._Fragment.apply(xt, top_p, pb["w_in"], pb["w_down"],
                                     top_i, run)

    before = gmm_kernel.launches
    fwd()
    out["gmm_launches_forward"] = gmm_kernel.launches - before
    out["forward_ms"] = host_ms(fwd, dev)
    leaves = [t.detach().requires_grad_(True)
              for t in (xt, top_p, pb["w_in"], pb["w_down"])]
    g = torch.randn((T, d), device=dev)
    bwd_ms, launches = [], 0
    for i in range(WARMUP + REPS):
        y = D._Fragment.apply(*leaves, top_i, run)
        _sync(dev)
        before = gmm_kernel.launches
        t = time.perf_counter()
        torch.autograd.backward(y, g)
        _sync(dev)
        if i >= WARMUP:
            bwd_ms.append(1e3 * (time.perf_counter() - t))
        launches = gmm_kernel.launches - before
        for t_ in leaves:
            t_.grad = None
    out["backward_ms"] = statistics.median(bwd_ms)
    out["gmm_launches_backward"] = launches
    # Where a call's time goes: device busy ms against the host clock.
    out["forward_busy_ms"] = busy_ms(fwd, dev)
    y = D._Fragment.apply(*leaves, top_i, run)
    out["backward_busy_ms"] = busy_ms(
        lambda: torch.autograd.backward(y, g), dev)
    info = cache.info()
    out["cache"] = {k: info[k] for k in ("hits", "misses", "entries",
                                         "pad_ratio")}
    return out


def timed_fixed(params, x, mc, dev) -> dict:
    """The fixed-capacity layer in bf16 through the kernels, as the
    training step runs it (``model.train_moe_impl``)."""
    pb = {k: (v.to(torch.bfloat16) if k != "router" else v)
          .detach().requires_grad_(True) for k, v in params.items()}
    xb = x.to(torch.bfloat16).requires_grad_(True)
    fn = partial(moe_grouped, act="swiglu",
                 gmm_fn=partial(ops.moe_expert_ffn, trainable=True))
    g = torch.randn(tuple(x.shape), device=dev).to(torch.bfloat16)

    def fwd():
        with torch.no_grad():
            return fn(pb, xb, mc)

    out = {"C": capacity(x.shape[1], mc), "forward_ms": host_ms(fwd, dev)}
    bwd_ms = []
    for i in range(WARMUP + REPS):
        y = fn(pb, xb, mc)
        _sync(dev)
        t = time.perf_counter()
        torch.autograd.backward(y, g)
        _sync(dev)
        if i >= WARMUP:
            bwd_ms.append(1e3 * (time.perf_counter() - t))
        for t_ in (xb, *pb.values()):
            t_.grad = None
    out["backward_ms"] = statistics.median(bwd_ms)
    out["forward_busy_ms"] = busy_ms(fwd, dev)
    y = fn(pb, xb, mc)
    out["backward_busy_ms"] = busy_ms(
        lambda: torch.autograd.backward(y, g), dev)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config's widths (CPU-sized)")
    ap.add_argument("--tokens", type=int, default=TOKENS)
    ap.add_argument("--ep", default=",".join(map(str, EPS)),
                    help="comma-separated EP sizes (virtual ranks)")
    ap.add_argument("--bucket", default="16", metavar="SPEC",
                    help="shape-bucket policy (the training default)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    from ..configs import get_config, get_smoke_config
    cfg = get_smoke_config(ARCH) if args.smoke else get_config(ARCH)
    mc = cfg.moe
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    params, x = layer(cfg, args.tokens, args.seed, dev)
    rows = []
    print("name,us_per_call,derived", flush=True)
    for ep in (int(e) for e in args.ep.split(",")):
        dc = D.DroplessConfig(ep=ep, bucket=args.bucket)
        row = {"ep": ep, "tokens": args.tokens, "d": cfg.d_model,
               "experts": mc.e_total, "top_k": mc.top_k, "F": mc.d_expert,
               "bucket": args.bucket, "checks": check(params, x, mc, dc)}
        if dev.type == "cuda":
            row.update(timed(params, x, mc, dc, dev))
        rows.append(row)
        c = row["checks"]
        derived = (f"tasks_fwd={c['tasks']['forward']} "
                   f"tasks_bwd={c['tasks']['backward']} "
                   f"err_plain={c['plain_executor']:.3g} "
                   f"err_fixed={c['fixed_capacity']:.3g} "
                   f"recompute_bit_equal={c['recompute_bit_equal']}")
        if "forward_ms" in row:
            derived += (f" backward_ms={row['backward_ms']:.2f} "
                        f"busy_fwd_ms={row['forward_busy_ms']:.2f} "
                        f"busy_bwd_ms={row['backward_busy_ms']:.2f} "
                        f"compile_fwd_ms={row['compile_forward_ms']:.2f} "
                        f"gmm_launches_fwd={row['gmm_launches_forward']}")
        else:
            derived += " time=not_measured"
        print(f"dropless_fragment_ep{ep},"
              f"{1e3 * row['forward_ms'] if 'forward_ms' in row else ''},"
              f"{derived} device={name.replace(' ', '_')}", flush=True)
    fixed = timed_fixed(params, x, mc, dev) if dev.type == "cuda" else None
    if fixed:
        print(f"fixed_capacity_moe_grouped,{1e3 * fixed['forward_ms']},"
              f"C={fixed['C']} backward_ms={fixed['backward_ms']:.2f} "
              f"busy_fwd_ms={fixed['forward_busy_ms']:.2f} "
              f"busy_bwd_ms={fixed['backward_busy_ms']:.2f} "
              f"device={name.replace(' ', '_')}", flush=True)
    return {"device": name, "rows": rows, "fixed_capacity": fixed}


if __name__ == "__main__":
    main()
