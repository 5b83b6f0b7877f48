"""EP execution modes side by side — twin of ``benchmarks/bench_ep_modes.py``.

The reference lowers the paper-style MoE block through both shard_map EP
paths on an 8-device forced-host CPU mesh and reports each mode's wall
time, collective op mix and bytes from the optimized HLO, then that the two
modes agree. This twin runs ``parallel.ep.make_moe_ep`` over a mesh of
virtual ranks (``launch.mesh``), counting the collectives and the bytes a
rank sends in the comm (``parallel.comm``), and prints the reference's
lines, ``ep_mode_{mode},{us},collectives=... bytes=...`` and the numerics
line, each mode first held against the same mode with the plain expert
FFN.

On the CPU, the reference's run: ``deepseek_moe_paper.smoke_config()``,
x [4, 32, d] fp32, mesh 2x4, ``capacity_factor`` 8.0, host µs:
    PYTHONPATH=src python -m repro_torch.launch.bench_ep_modes --device cpu
On the card, ``--full``: the paper's module, ``config(ep=4)``, one MoE
layer (d 7168, 32 experts of F = 2048, top-8, 8 a rank), 8192 tokens a
rank (x [4, 8192, d], 32,768 tokens), bf16, the default capacity factor
1.25, mesh 1x4; per mode also the forward and forward + backward ms (CUDA
events), the kernels' launches in one forward, and the peak memory:
    PYTHONPATH=src python -m repro_torch.launch.bench_ep_modes --full

A forward's expert-FFN calls (``F``) are ep x ep in the ring (every rank,
every step) and ep in the baseline; each launches ``gmm_swiglu`` and
``gmm`` once.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..configs.deepseek_moe_paper import config, smoke_config
from ..device import resolve_device
from ..kernels import gmm as gmm_kernel
from ..kernels import gmm_swiglu as swiglu_kernel
from ..models.moe import init_moe
from ..parallel.ep import EPConfig, _pair_capacity, make_moe_ep
from .mesh import make_test_mesh

MODES = ("baseline", "hyperparallel")
# The reference's run, and the paper's module on one card.
SMOKE = dict(mesh=(2, 4), shape=(4, 32), dtype=torch.float32,
             capacity_factor=8.0)
FULL = dict(mesh=(1, 4), shape=(4, 8192), dtype=torch.bfloat16,
            capacity_factor=EPConfig.capacity_factor)
# Each mode against its plain FFN: |got - plain| <= PLAIN_TOL x max|plain|;
# the modes against each other in the reference's fp32 tolerance, or that
# bf16 one on the card.
PLAIN_TOL, MODES_TOL_FP32 = 2e-2, 2e-4
WARMUP, REPS = 1, 3


def ffn_calls(mode: str, ep: int, n_dp: int) -> int:
    """Expert-FFN calls in one forward over the mesh."""
    return n_dp * (ep * ep if mode == "hyperparallel" else ep)


def _time_ms(fn, dev) -> float:
    """Mean ms of ``fn()``: CUDA events on the card, the host clock on the
    CPU."""
    for _ in range(WARMUP):
        fn()
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / REPS
    t = time.perf_counter()
    for _ in range(REPS):
        fn()
    return 1e3 * (time.perf_counter() - t) / REPS


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="the paper's module at 8192 tokens a rank, bf16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    run = FULL if args.full else SMOKE
    cfg = config(ep=run["mesh"][1], n_layers=1) if args.full \
        else smoke_config()
    mc, d, dtype = cfg.moe, cfg.d_model, run["dtype"]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_moe(gen, d, mc, dtype)
    x = torch.randn(run["shape"] + (d,), generator=gen, device=dev,
                    dtype=torch.float32).to(dtype)
    cot = torch.randn(x.shape, generator=gen, device=dev,
                      dtype=torch.float32).to(dtype)
    mesh = make_test_mesh(*run["mesh"], device=dev)
    ep, n_dp = mesh.shape["model"], mesh.dp_size
    cuda = dev.type == "cuda"
    print(f"device {torch.cuda.get_device_name(dev) if cuda else 'cpu'}, "
          f"{cfg.name}, x {list(x.shape)} {str(dtype)[6:]}, mesh "
          f"{run['mesh'][0]}x{ep}", flush=True)

    out = {"config": cfg.name, "x": list(x.shape),
           "dtype": str(dtype).removeprefix("torch."),
           "mesh": list(run["mesh"]), "capacity_factor":
           run["capacity_factor"], "device": str(dev), "modes": {}}
    results = {}
    for mode in MODES:
        epc = EPConfig(mode=mode, capacity_factor=run["capacity_factor"])
        impl = make_moe_ep(mesh, epc, cfg.act)
        plain = make_moe_ep(mesh, EPConfig(
            mode=mode, capacity_factor=run["capacity_factor"],
            use_pallas=False), cfg.act)
        with torch.no_grad():
            want = plain(params, x, mc)
            mesh.comm.stats.reset()
            n_gs, n_g = swiglu_kernel.launches, gmm_kernel.launches
            y = impl(params, x, mc)
            if cuda:
                torch.cuda.synchronize(dev)
            launches = {"gmm_swiglu": swiglu_kernel.launches - n_gs,
                        "gmm": gmm_kernel.launches - n_g}
            stats = mesh.comm.stats
            counts = {k: v // n_dp for k, v in sorted(stats.counts.items())}
            nbytes = stats.bytes // n_dp
        err = float((y.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        if not (torch.isfinite(y).all() and err <= PLAIN_TOL * scale):
            raise AssertionError(f"{mode}: kernels vs plain FFN {err} > "
                                 f"{PLAIN_TOL} x {scale}")
        calls = ffn_calls(mode, ep, n_dp)
        if cuda and launches != {"gmm_swiglu": calls, "gmm": calls}:
            raise AssertionError(f"{mode}: launches {launches}, want "
                                 f"{calls} of each")
        results[mode] = y
        with torch.no_grad():
            fwd_ms = _time_ms(lambda: impl(params, x, mc), dev)
        row = {"forward_ms": fwd_ms, "collectives": counts,
               "bytes_per_rank": nbytes, "launches": launches,
               "ffn_calls": calls, "max_abs_err_vs_plain": err,
               "plain_scale": scale,
               "pair_capacity": _pair_capacity(
                   x.shape[0] // n_dp * x.shape[1] // ep, mc, ep,
                   run["capacity_factor"])}
        print(f"ep_mode_{mode},{1e3 * fwd_ms:.2f},collectives={counts}"
              f" bytes={nbytes}", flush=True)
        if cuda:
            p = {k: v.detach().requires_grad_(True)
                 for k, v in params.items()}
            xg = x.detach().requires_grad_(True)

            def fwd_bwd():
                impl(p, xg, mc).backward(cot)
                for t in (xg, *p.values()):
                    t.grad = None
            torch.cuda.reset_peak_memory_stats(dev)
            row["forward_backward_ms"] = _time_ms(fwd_bwd, dev)
            row["max_memory_allocated_bytes"] = \
                torch.cuda.max_memory_allocated(dev)
            del p, xg
            torch.cuda.empty_cache()
        out["modes"][mode] = row
        print(json.dumps({"mode": mode, **row}), flush=True)

    a, b = results["baseline"].float(), results["hyperparallel"].float()
    bits = bool(torch.equal(results["baseline"], results["hyperparallel"]))
    diff = float((a - b).abs().max())
    if dtype == torch.float32:
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=MODES_TOL_FP32, atol=MODES_TOL_FP32)
    elif diff > PLAIN_TOL * float(a.abs().max()):
        raise AssertionError(f"baseline and hyperparallel differ by {diff}")
    out["modes_max_abs_diff"] = diff
    out["modes_bit_equal"] = bits
    print(f"ep_modes_numerics,0.00,baseline==hyperparallel allclose ok "
          f"(bit-equal: {bits})", flush=True)
    return out


if __name__ == "__main__":
    main()
