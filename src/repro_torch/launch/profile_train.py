"""Where a training step's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_train [--dropless]
    PYTHONPATH=src python -m repro_torch.launch.profile_train --mesh 1x4 \
        --ep-mode hyperparallel
    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        --arch mamba2-1.3b
    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        --arch internvl2-26b --n-layers 4

Trains ``--arch`` (default granite-moe-3b-a800m) at full width and depth
with the shapes of ``chip_smoke.py``'s training phase: batches of 1 x 4096
tokens from ``SyntheticStream``, bf16, per-layer remat, AdamW. It runs
``WARMUP`` steps, times ``STEPS`` more on the host clock, unprofiled, then
traces ``STEPS`` steps with ``torch.profiler`` and prints one JSON line: the
unprofiled and the profiled host ms per step, the device's busy ms per step
(the sum of kernel times; the port runs on one stream, so kernels do not
overlap), the idle share of the unprofiled step, the kernel launches per
step, the device ms per step of the port's own CUDA kernels by namespace
(``OWN``: the tensor-core body of ``gmm_swiglu`` and ``gmm``, their FMA
body, ``gmm``'s fp32 tiled, narrow and small-row bodies, the tensor-core
and FMA bodies of ``gmm_swiglu_bwd``, ``swiglu_add``) against all other
kernels, each of the port's own kernels by name, the ``TOP`` kernels with the
most device time, and the card's peak allocated bytes over the run. ``--dropless`` trains the MoE through the dropless tile
taskflow (``launch.dropless``, its default config), as ``launch.train
--dropless`` does. ``--mesh DxM`` runs the MoE expert-parallel over the
mesh's model axis of virtual ranks (``--ep-mode``, capacity factor 4.0), as
``launch.train --mesh`` does; both need a MoE arch. ``--n-layers N`` cuts
the depth: internvl2-26b's 48 layers with fp32 AdamW state (12 bytes a
parameter) do not fit one card, 4 do. Batches are tokens, as the training
launcher's; the audio encoder, which trains on features, is refused. Needs
a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import get_config
from ..data.pipeline import DataConfig, SyntheticStream
from ..device import resolve_device
from ..models import model as M
from ..optim import adamw
from ..parallel.ep import EPConfig
from . import steps as St
from .dropless import DroplessConfig
from .mesh import make_mesh, mesh_dims
from .train import pad_experts

ARCH, BATCH, SEQ = "granite-moe-3b-a800m", 1, 4096
WARMUP, STEPS = 1, 2
TOP = 25   # kernels listed by device time
# Device kernels of the port's CUDA sources, by their C++ namespaces: every
# namespace under kernels/csrc has a bucket (a test holds them equal).
OWN = {"gmm_swiglu and gmm, tensor cores (gmmtc::)": "gmmtc::",
       "gmm_swiglu and bf16 gmm, FMA body (gmmk::)": "gmmk::",
       "gmm fp32 tiled body (gmmf::)": "gmmf::",
       "gmm fp32 narrow body (gmmn::)": "gmmn::",
       "gmm fp32 small-row body (gmms::)": "gmms::",
       "gmm_swiglu_bwd, tensor cores (gsbtc::)": "gsbtc::",
       "gmm_swiglu_bwd, FMA body (gsb::)": "gsb::",
       "swiglu_add (swa::)": "swa::"}


def _device_us(evt) -> float:
    return float(evt.self_device_time_total)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=ARCH)
    ap.add_argument("--dropless", action="store_true",
                    help="the MoE through the dropless tile taskflow")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="the MoE expert-parallel over DxM virtual ranks")
    ap.add_argument("--ep-mode", default="hyperparallel",
                    choices=["hyperparallel", "baseline"])
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the arch to this many layers")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    if (args.dropless or args.mesh) and cfg.family != "moe":
        ap.error(f"--dropless and --mesh need a MoE arch, not {args.arch!r}")
    if cfg.family == "audio":
        ap.error(f"{args.arch!r} trains on features; the profile feeds "
                 f"token batches")
    dev = resolve_device("cuda")
    mesh = ep = None
    if args.mesh:
        mesh = make_mesh(mesh_dims(args.mesh), dev)
        cfg = pad_experts(cfg, mesh.shape["model"])
        ep = EPConfig(mode=args.ep_mode, capacity_factor=4.0)
    params = adamw.cast_params(
        M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                      device=dev), cfg.compute_dtype)
    state = adamw.init_opt_state(params)
    step = St.make_train_step(cfg, adamw.OptConfig(
        lr=1e-3, warmup_steps=2, total_steps=WARMUP + 2 * STEPS),
        dropless=DroplessConfig() if args.dropless else None, mesh=mesh,
        ep=ep)
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                        global_batch=BATCH))
    batches = [stream.batch(i, dev) for i in range(WARMUP + 2 * STEPS)]
    for b in batches[:WARMUP]:
        params, state, _ = step(params, state, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[WARMUP:WARMUP + STEPS]:
        params, state, _ = step(params, state, b)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[WARMUP + STEPS:]:
            params, state, _ = step(params, state, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    kernels = [e for e in prof.key_averages() if _device_us(e) > 0
               and "CUDA" in str(getattr(e, "device_type", ""))]
    busy_us = sum(_device_us(e) for e in kernels)
    own = {label: sum(_device_us(e) for e in kernels if part in e.key)
           / 1e3 / STEPS for label, part in OWN.items()}
    ranked = sorted(kernels, key=_device_us, reverse=True)

    def rows(evts):
        return [{"name": e.key[:90], "calls_per_step": e.count / STEPS,
                 "device_ms_per_step": _device_us(e) / 1e3 / STEPS}
                for e in evts]
    step_ms = 1e3 * plain_wall / STEPS
    busy_ms = busy_us / 1e3 / STEPS
    out = {
        "arch": cfg.name, "n_layers": cfg.n_layers, "batch": BATCH,
        "seq": SEQ, "steps": STEPS,
        "moe": ("dropless" if args.dropless else
                f"EP {args.ep_mode} over {args.mesh}" if args.mesh
                else "fixed capacity"),
        "device": torch.cuda.get_device_name(0),
        "step_ms": step_ms,
        "step_ms_profiled": 1e3 * wall / STEPS,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / step_ms if busy_us else None,
        "kernel_launches_per_step": sum(e.count for e in kernels) / STEPS,
        "own_kernels_device_ms_per_step": own,
        "other_kernels_device_ms_per_step": busy_ms - sum(own.values()),
        "own_kernels": rows(e for e in ranked
                            if any(part in e.key for part in OWN.values())),
        "top_kernels": rows(ranked[:TOP]),
        "peak_bytes": torch.cuda.max_memory_allocated(dev),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
