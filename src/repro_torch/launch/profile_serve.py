"""Where a serving decode step's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve

Serves granite-moe-3b-a800m at full width and depth with the shapes of
``chip_smoke.py``: every one of 8 slots holds a prefilled 128-token request.
It times ``WARMUP`` decode steps on the host clock, unprofiled, then traces
``STEPS`` decode steps with ``torch.profiler`` and prints one JSON line: the
unprofiled and the profiled host ms per step, the device's busy ms per step
(the sum of kernel times; the port runs on one stream, so kernels do not
overlap), the idle share of the unprofiled step, the kernel launches per
step, and the kernels with the most device time. Needs a CUDA device.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import get_config
from ..device import resolve_device
from ..models import model as M
from .serve import ContinuousBatcher

ARCH, SLOTS, PROMPT_LEN = "granite-moe-3b-a800m", 8, 128
WARMUP, STEPS = 8, 8


def _device_us(evt) -> float:
    return float(evt.self_device_time_total)


def main():
    dev = resolve_device("cuda")
    cfg = get_config(ARCH)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    rng = np.random.default_rng(0)
    max_new = WARMUP + STEPS + 3          # no request finishes while timed
    b = ContinuousBatcher(cfg, params, n_slots=SLOTS,
                          max_len=PROMPT_LEN + max_new + 1, device=dev)
    with torch.inference_mode():
        for rid in range(SLOTS):
            b.admit(rid, rng.integers(0, cfg.vocab, PROMPT_LEN), max_new)
        b.step()                          # first step: one-time set-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(WARMUP):
            b.step()
        plain_wall = time.perf_counter() - t0
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
        "step_ms": step_ms,
        "step_ms_profiled": 1e3 * wall / STEPS,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / step_ms if busy_us else None,
        "kernel_launches_per_step": sum(e.count for e in kernels) / STEPS,
        "top_kernels": [{"name": e.key[:90], "calls_per_step":
                         e.count / STEPS,
                         "device_ms_per_step": _device_us(e) / 1e3 / STEPS}
                        for e in top],
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
