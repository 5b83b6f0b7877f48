"""Training on one device — counterpart of ``repro.launch.train``.

On the card (the default), granite-moe-3b-a800m at full width and depth on
4096-token batches:
    PYTHONPATH=src python -m repro_torch.launch.train --seq 4096 \\
        --global-batch 1 --steps 4
On the CPU, at the smoke size:
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu

Params come from ``init_params`` (seed 0), cast to the compute dtype as the
JAX launcher casts them; batches from ``SyntheticStream``. Each step logs
its loss, grad norm and host-clock ms (the step ends by waiting for the
device). The JAX launcher's mesh, EP, dropless and checkpoint options
belong to later slices of the port and are refused.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..device import resolve_device
from ..data.pipeline import DataConfig, SyntheticStream
from ..models import model as M
from ..optim import adamw
from . import steps as St

# Options of the JAX launcher and the slice of the port that brings them.
_REFUSED = {
    "--mesh": "the port's EP/sharding slice",
    "--mode": "the port's EP/sharding slice",
    "--dropless": "the port's dropless-executor slice",
    "--sched": "the port's schedule-compiler slice",
    "--ckpt-dir": "the port's checkpoint/fault-tolerance slice",
    "--ckpt-every": "the port's checkpoint/fault-tolerance slice",
}


@dataclasses.dataclass
class TrainRun:
    params: dict
    opt_state: dict
    metrics_log: list   # per step: step, loss, grad_norm, lr, step_ms


def main(argv=None) -> TrainRun:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite-moe-3b-a800m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    for flag in _REFUSED:
        ap.add_argument(flag, nargs="?", const=True, default=None,
                        help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    for flag, later in _REFUSED.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            ap.error(f"{flag} is not ported yet; it comes with {later}")

    from ..configs import get_config, get_smoke_config
    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    oc = adamw.OptConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                         total_steps=args.steps)
    step_fn = St.make_train_step(cfg, oc)
    params = adamw.cast_params(
        M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                      device=dev), cfg.compute_dtype)
    opt_state = adamw.init_opt_state(params)
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                        global_batch=args.global_batch))
    log = []
    for s in range(args.steps):
        batch = stream.batch(s, dev)
        t = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms = 1e3 * (time.perf_counter() - t)
        rec = {"step": s, "loss": float(m["loss"]),
               "grad_norm": float(m["grad_norm"]), "lr": m["lr"],
               "step_ms": ms}
        log.append(rec)
        print(f"step {s:4d} loss {rec['loss']:.4f} "
              f"gnorm {rec['grad_norm']:.3f} {ms:.0f}ms", flush=True)
    return TrainRun(params=params, opt_state=opt_state, metrics_log=log)


if __name__ == "__main__":
    main()
