"""K consecutive dropless MoE layers as one fused block
(``launch.dropless.FusedDroplessMoE``) beside their sequential twin.

The paper's cross-layer extension: layer N's Combine and layer N+1's
Dispatch meet in one taskflow, joined by LayerBoundary tiles that run the
token remap between them, instead of a barrier and a host-side bridge.

On the card (the default), K = 2 granite-moe-3b-a800m MoE layers at full
width (d 1536, 48 experts of F = 512, top-8), each with its own router and
expert weights from the seed, on T = 4096 standard normals, at ep = 1 and
ep = 4 (virtual ranks on the one card; their puts are device copies, not a
collective), bucket ``linear:16``, passes ``ratr`` + ``gmm_interleave``:
    PYTHONPATH=src python -m repro_torch.launch.bench_fused_dropless
On the CPU, at the smoke config's widths (ep = 1 and 2) and without times:
    PYTHONPATH=src python -m repro_torch.launch.bench_fused_dropless \\
        --device cpu --smoke --tokens 64

Each ep is first held, in fp32: the fused block's output and every
gradient (x, each router, w_in and w_down) bit-equal to the sequential
twin's (``fuse=False``), both within ``TOL_PLAIN`` of the fused block on
the plain executor (``kernels.ref.gmm_ref`` tiles; y elementwise, every
grad by its relative error norm), the fused blobs holding K fragments and
the twin's one.

Then timed on the card with bf16 inputs (cast to fp32 inside, as the
dropless training path passes them), host clock around calls that end in
``synchronize``, median of ``REPS`` after ``WARMUP``, the fused block and
its twin called alternately (the host's clock drifts by tens of ms
between runs), with the median of their paired ratios: forward (a cache
hit) and backward ms, device busy ms in one
traced call (``torch.profiler``), compile ms on a miss (the fused blob,
or the twin's K per-layer schedules), tasks and ``gmm`` launches a call,
and ``core.autoselect.select_fused``'s verdict and predicted µs — a
prediction of the Ascend A3 model, not a measurement.
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from ..core.autoselect import select_fused
from ..core.ssc import SSCCache
from ..device import resolve_device
from ..kernels import gmm as gmm_kernel
from ..kernels.ref import gmm_ref
from ..models.moe import init_moe, router_topk
from . import dropless as D
from .bench_dropless import _close, _sync, busy_ms, host_ms


ARCH = "granite-moe-3b-a800m"
TOKENS = 4096
LAYERS = 2
EPS = (1, 4)
SMOKE_EPS = (1, 2)          # the smoke config's 6 experts
WARMUP, REPS = 2, 7
# fp32, against the plain executor, which makes the same products in
# another summation order (torch.matmul): y elementwise, |got - want| <=
# tol + tol·|want|; every grad by ||got - want|| / ||want|| <= tol. A
# router's grad sums all T tokens' products, so its entries near zero
# carry the order's rounding beyond an elementwise 1e-5 (5.3e-5 at full
# width on an H100, this script's check).
TOL_PLAIN = 1e-5


def rel_err(got, want) -> float:
    """||got - want|| / ||want||, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-300))


def block(cfg, tokens: int, seed: int, dev):
    """``LAYERS`` layers' fp32 params (each its own router and experts) and
    x [1, tokens, d], all from ``seed``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = [init_moe(gen, cfg.d_model, cfg.moe) for _ in range(LAYERS)]
    x = torch.randn((1, tokens, cfg.d_model), generator=gen, device=dev)
    return params, x


def run_block(handle, params, x, mc, g) -> dict:
    """One forward and backward of ``handle.impl``: y and every grad,
    the params' named per layer (``w_in0``, ...)."""
    leaves = [{k: v.detach().clone().requires_grad_(True)
               for k, v in p.items()} for p in params]
    xx = x.detach().clone().requires_grad_(True)
    y = handle.impl(leaves, xx, mc)
    y.backward(g)
    out = {"y": y.detach(), "dx": xx.grad}
    for i, p in enumerate(leaves):
        for k in ("router", "w_in", "w_down"):
            out[f"{k}{i}"] = p[k].grad
    return out


def check(params, x, mc, dc, dev) -> dict:
    """Fused against sequential (bit for bit) and against the plain
    executor (``TOL_PLAIN``), fp32; returns each output's max |err| and
    relative error norm against the plain executor, and the fragments of
    each handle's cache entries."""
    g = torch.randn(tuple(x.shape), generator=torch.Generator(
        device=dev).manual_seed(7), device=dev)
    handles = {
        "fused": D.FusedDroplessMoE(dc, cache=SSCCache(), fuse=True,
                                    device=dev),
        "sequential": D.FusedDroplessMoE(dc, cache=SSCCache(), fuse=False,
                                         device=dev),
        "plain": D.FusedDroplessMoE(dc, cache=SSCCache(), fuse=True,
                                    device=dev, gmm=gmm_ref)}
    before = gmm_kernel.launches
    got = {name: run_block(h, params, x, mc, g)
           for name, h in handles.items()}
    out = {"gmm_launches": gmm_kernel.launches - before}
    for k, v in got["fused"].items():
        if not torch.equal(v, got["sequential"][k]):
            raise AssertionError(f"fused dropless {k}: the fused block "
                                 f"differs from its sequential twin")
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"fused dropless {k}: non-finite")
    out["bit_equal_sequential"] = True
    out["plain_executor"] = {"y": _close("fused y vs the plain executor",
                                         got["fused"]["y"],
                                         got["plain"]["y"], TOL_PLAIN)}
    out["plain_executor_rel"] = {}
    for k, v in got["fused"].items():
        want = got["plain"][k]
        out["plain_executor"][k] = float((v - want).abs().max())
        out["plain_executor_rel"][k] = rel_err(v, want)
        if out["plain_executor_rel"][k] > TOL_PLAIN:
            raise AssertionError(
                f"fused dropless {k}: relative error "
                f"{out['plain_executor_rel'][k]} from the plain executor "
                f"beyond {TOL_PLAIN}")
    out["fragments"] = {
        name: sorted({e["fragments"] for e in h.cache.info()["per_entry"]})
        for name, h in handles.items()}
    K = len(params)
    if out["fragments"]["fused"] != [K] or \
            out["fragments"]["sequential"] != [1]:
        raise AssertionError(f"fused dropless blobs: {out['fragments']}")
    return out


def timed(params, x, mc, dc, dev) -> dict:
    """Card times of the fused block and its sequential twin (bf16 inputs,
    as training passes them)."""
    T, d = x.shape[1], x.shape[2]
    pb = [{k: v.to(torch.bfloat16) if k != "router" else v
           for k, v in p.items()} for p in params]
    xb = x.to(torch.bfloat16)
    xt = xb.reshape(T, d)
    tis = [router_topk(p["router"], xt, mc)[1].cpu().numpy() for p in pb]
    blk = D._Block(dc, None, mc, True, None, len(pb))
    _, cfgs = blk.plans(tis, d)
    pipe = dc.pipeline_spec()
    out = {}
    for direction in ("forward", "backward"):
        sel = select_fused(cfgs, direction=direction)
        out[f"select_fused_{direction}"] = {
            "fuse": sel.fuse, "predicted_fused_us": sel.predicted_fused_us,
            "predicted_per_layer_us": sel.predicted_per_layer_us,
            "note": "a prediction of the Ascend A3 model"}
    g = torch.randn((1, T, d), device=dev).to(torch.bfloat16)
    handles = {}
    for name, fuse in (("fused", True), ("sequential", False)):
        row = out[name] = {}
        for direction in ("forward", "backward"):
            if fuse:
                def miss():
                    return SSCCache().get_or_compile_fused(
                        cfgs, direction, pipeline=pipe)
            else:
                def miss():
                    c = SSCCache()
                    return [c.get_or_compile(cfg, direction, pipeline=pipe)
                            for cfg in cfgs]
            row[f"compile_{direction}_ms"] = host_ms(miss, dev, 3, 1)
            s = miss()
            row[f"tasks_{direction}"] = (s.n_tasks if fuse else
                                         sum(x_.n_tasks for x_ in s))
        handles[name] = D.FusedDroplessMoE(dc, cache=SSCCache(), fuse=fuse,
                                           device=dev)
    leaves = [{k: v.detach().requires_grad_(True) for k, v in p.items()}
              for p in pb]
    xl = xb.detach().requires_grad_(True)

    def fwd(h):
        with torch.no_grad():
            return h.impl(pb, xb, mc)

    def bwd(h):
        """Backward ms and its gmm launches (the forward before it not
        timed)."""
        y = h.impl(leaves, xl, mc)
        _sync(dev)
        before = gmm_kernel.launches
        t = time.perf_counter()
        torch.autograd.backward(y, g)
        _sync(dev)
        ms = 1e3 * (time.perf_counter() - t)
        for p in leaves:
            for v in p.values():
                v.grad = None
        xl.grad = None
        return ms, gmm_kernel.launches - before

    # The two run alternately, so that the host's drift falls on both.
    ms = {(n, dr): [] for n in handles for dr in ("forward", "backward")}
    for i in range(WARMUP + REPS):
        for name, h in handles.items():
            before = gmm_kernel.launches
            t = time.perf_counter()
            fwd(h)
            _sync(dev)
            f_ms = 1e3 * (time.perf_counter() - t)
            out[name]["gmm_launches_forward"] = \
                gmm_kernel.launches - before
            b_ms, out[name]["gmm_launches_backward"] = bwd(h)
            if i >= WARMUP:
                ms[name, "forward"].append(f_ms)
                ms[name, "backward"].append(b_ms)
    for name, h in handles.items():
        row = out[name]
        for dr in ("forward", "backward"):
            row[f"{dr}_ms"] = statistics.median(ms[name, dr])
            row[f"{dr}_ms_reps"] = ms[name, dr]
        row["forward_busy_ms"] = busy_ms(lambda: fwd(h), dev)
        y = h.impl(leaves, xl, mc)
        row["backward_busy_ms"] = busy_ms(
            lambda: torch.autograd.backward(y, g), dev)
        info = h.cache.info()
        row["cache"] = {k: info[k] for k in ("hits", "misses", "entries")}
    out["fused_over_sequential"] = {
        dr: statistics.median(f / s for f, s in zip(
            ms["fused", dr], ms["sequential", dr]))
        for dr in ("forward", "backward")}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config's widths (CPU-sized)")
    ap.add_argument("--tokens", type=int, default=TOKENS)
    ap.add_argument("--ep", default=None,
                    help="comma-separated EP sizes (virtual ranks); "
                         "default 1,4 (1,2 with --smoke)")
    ap.add_argument("--bucket", default="16", metavar="SPEC",
                    help="shape-bucket policy (the training default)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    from ..configs import get_config, get_smoke_config
    cfg = get_smoke_config(ARCH) if args.smoke else get_config(ARCH)
    mc = cfg.moe
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    params, x = block(cfg, args.tokens, args.seed, dev)
    rows = []
    print("name,us_per_call,derived", flush=True)
    eps = ([int(e) for e in args.ep.split(",")] if args.ep
           else SMOKE_EPS if args.smoke else EPS)
    for ep in eps:
        dc = D.DroplessConfig(ep=ep, bucket=args.bucket)
        row = {"ep": ep, "layers": LAYERS, "tokens": args.tokens,
               "d": cfg.d_model, "experts": mc.e_total, "top_k": mc.top_k,
               "F": mc.d_expert, "bucket": args.bucket,
               "checks": check(params, x, mc, dc, dev)}
        if dev.type == "cuda":
            row.update(timed(params, x, mc, dc, dev))
        rows.append(row)
        c = row["checks"]
        derived = (f"bit_equal_sequential={c['bit_equal_sequential']} "
                   f"err_plain={max(c['plain_executor'].values()):.3g} "
                   f"rel_err_plain="
                   f"{max(c['plain_executor_rel'].values()):.3g}")
        for tag in ("fused", "sequential"):
            if tag in row:
                r = row[tag]
                derived += (f" {tag}_fwd_ms={r['forward_ms']:.2f}"
                            f" {tag}_bwd_ms={r['backward_ms']:.2f}"
                            f" {tag}_busy_fwd_ms={r['forward_busy_ms']:.2f}"
                            f" {tag}_busy_bwd_ms={r['backward_busy_ms']:.2f}"
                            f" {tag}_compile_fwd_ms="
                            f"{r['compile_forward_ms']:.2f}")
        if "fused" in row:
            derived += (" fused_over_sequential_fwd="
                        f"{row['fused_over_sequential']['forward']:.3f}"
                        " fused_over_sequential_bwd="
                        f"{row['fused_over_sequential']['backward']:.3f}")
        else:
            derived += " time=not_measured"
        print(f"fused_dropless_k{LAYERS}_ep{ep},"
              f"{1e3 * row['fused']['forward_ms'] if 'fused' in row else ''},"
              f"{derived} device={name.replace(' ', '_')}", flush=True)
    return {"device": name, "rows": rows}


if __name__ == "__main__":
    main()
