"""Where a serving decode step's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve [--online-refit]
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch recurrentgemma-2b

Serves ``--arch`` (default granite-moe-3b-a800m) at full width and depth
with the shapes of ``chip_smoke.py``: every one of 8 slots holds a prefilled
128-token request. It times ``WARMUP`` decode steps on the host clock,
unprofiled, then traces ``STEPS`` decode steps with ``torch.profiler`` and
prints one JSON line: the unprofiled and the profiled host ms per step, the
device's busy ms per step (the sum of kernel times; the port runs on one
stream, so kernels do not overlap), the host-only ms (the unprofiled step
less the busy time) and the idle share of the unprofiled step, the kernel
launches per step, the device ms per step of the port's own CUDA kernels by
namespace (``profile_train.OWN``), and the kernels with the most device
time.

``--online-refit`` serves the MoE layers as ``serve --online-refit`` does:
the dropless fragment at ep = 4 under an ``OnlineTuner`` seeded with the
ladder fitted on the decode population (MoE archs only). The line then also
gives, per decode step over the unprofiled steps, ``gmm`` launches by body
(the fp32 narrow, small-row and tiled bodies), SSC hits and misses (a miss is a
compile), and the tuner's refits and swaps. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import get_config
from ..core.ssc import SSCCache
from ..device import resolve_device
from ..kernels import gmm as gmm_mod
from ..models import model as M
from .profile_train import OWN
from .serve import (ContinuousBatcher, decode_population, make_online_moe,
                    serving_ep)

ARCH, SLOTS, PROMPT_LEN = "granite-moe-3b-a800m", 8, 128
WARMUP, STEPS = 8, 8


def _device_us(evt) -> float:
    return float(evt.self_device_time_total)


def _counters(online) -> dict:
    c = {"gmm": gmm_mod.launches,
         "gmm_fp32_narrow": gmm_mod.launches_fp32_narrow,
         "gmm_fp32_small": gmm_mod.launches_fp32_small,
         "gmm_fp32_tiled": gmm_mod.launches_fp32_tiled}
    if online is not None:
        info = online.cache.info()
        c.update(ssc_hits=info["hits"], ssc_misses=info["misses"],
                 refits=online.tuner.refits, swaps=len(online.tuner.swaps))
    return c


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=ARCH)
    ap.add_argument("--online-refit", action="store_true",
                    help="serve the MoE layers through the online-tuned "
                         "dropless fragment")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.online_refit and cfg.family != "moe":
        ap.error(f"--online-refit needs a MoE arch, not {args.arch!r}")
    dev = resolve_device("cuda")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    online = None
    if args.online_refit:
        ep = serving_ep(cfg.moe, SLOTS, PROMPT_LEN)
        online = make_online_moe(cfg, ep,
                                 decode_population(cfg.moe, ep, SLOTS),
                                 cache=SSCCache())
    rng = np.random.default_rng(0)
    max_new = WARMUP + STEPS + 3          # no request finishes while timed
    b = ContinuousBatcher(cfg, params, n_slots=SLOTS,
                          max_len=PROMPT_LEN + max_new + 1,
                          moe_impl=online.impl if online else None,
                          device=dev)
    with torch.inference_mode():
        for rid in range(SLOTS):
            b.admit(rid, rng.integers(0, cfg.vocab, PROMPT_LEN), max_new)
        b.step()                          # first step: one-time set-up
        torch.cuda.synchronize()
        before = _counters(online)
        t0 = time.perf_counter()
        for _ in range(WARMUP):
            b.step()
        plain_wall = time.perf_counter() - t0
        after = _counters(online)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(STEPS):
                b.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0

    kernels = [e for e in prof.key_averages() if _device_us(e) > 0
               and "CUDA" in str(getattr(e, "device_type", ""))]
    busy_us = sum(_device_us(e) for e in kernels)
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    step_ms = 1e3 * plain_wall / WARMUP
    busy_ms = busy_us / 1e3 / STEPS
    out = {
        "arch": cfg.name, "slots": SLOTS, "steps": STEPS,
        "device": torch.cuda.get_device_name(0),
        "moe": ("online-refit dropless, ep=%d" % online.dc.ep if online
                else "fixed-capacity kernels"),
        "step_ms": step_ms,
        "step_ms_profiled": 1e3 * wall / STEPS,
        "device_busy_ms_per_step": busy_ms,
        "host_only_ms_per_step": step_ms - busy_ms,
        "device_idle_share": 1.0 - busy_ms / step_ms if busy_us else None,
        "kernel_launches_per_step": sum(e.count for e in kernels) / STEPS,
        "own_kernels_ms_per_step": {
            label: sum(_device_us(e) for e in kernels if part in e.key)
            / 1e3 / STEPS for label, part in OWN.items()},
        "per_step": {k: (after[k] - before[k]) / WARMUP for k in before},
        "top_kernels": [{"name": e.key[:90], "calls_per_step":
                         e.count / STEPS,
                         "device_ms_per_step": _device_us(e) / 1e3 / STEPS}
                        for e in top],
    }
    if online is not None:
        out["tuner"] = online.tuner.summary()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
