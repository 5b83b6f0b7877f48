"""End-to-end MoE training: a ~100M-parameter model with the production
substrate — data pipeline, mixed-precision AdamW, checkpointing,
auto-resume and the straggler watchdog (``ft.runner.train_loop``) —
counterpart of ``examples/train_moe_e2e.py``.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_moe_e2e \\
          [--steps 300] [--ckpt-dir DIR]

Without ``--ckpt-dir`` the checkpoints go to a new directory from
``tempfile`` (printed); pass it back as ``--ckpt-dir`` to resume. On the
card the expert FFN runs the GMM kernels with their backward (the model's
normal MoE path).
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile

import torch

from ..configs import get_smoke_config
from ..data.pipeline import DataConfig, SyntheticStream
from ..device import resolve_device
from ..ft.runner import FTConfig, train_loop
from ..launch.steps import make_train_step
from ..models import model as M
from ..models.moe import MoEConfig
from ..optim import adamw


def model_config():
    """The reference example's model: d_model 256, 4 layers, 8 experts."""
    return dataclasses.replace(
        get_smoke_config("granite-moe-3b-a800m"),
        name="moe-100m", n_layers=4, d_model=256, n_heads=8, n_kv_heads=4,
        vocab=32000, vocab_pad=128,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=512),
        remat=False)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoints, resumed from when present "
                         "(default: a new temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="moe_e2e_ckpt_")

    cfg = model_config()
    print(f"model: {cfg.name}  params={cfg.param_count() / 1e6:.1f}M  "
          f"device={dev}  checkpoints={ckpt_dir}")
    params = adamw.cast_params(M.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev),
        cfg.compute_dtype)
    opt_state = adamw.init_opt_state(params)
    step_fn = make_train_step(cfg, adamw.OptConfig(
        lr=1e-3, warmup_steps=20, total_steps=args.steps))
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                        global_batch=args.batch))
    run = train_loop(
        step_fn=step_fn, params=params, opt_state=opt_state, stream=stream,
        mesh=None, device=dev, n_steps=args.steps,
        ft=FTConfig(ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every),
        log_every=args.log_every)

    if run.resumed_from is not None:
        print(f"(auto-resumed from step {run.resumed_from})")
    for m in run.metrics_log:
        print(f"step {m['step']:4d} loss {m['loss']:.4f} "
              f"gnorm {m['grad_norm']:.3f} {m['step_time_s'] * 1e3:.0f}ms")
    if run.stragglers:
        print(f"straggler events: {run.stragglers}")
    if run.metrics_log:
        first, last = (run.metrics_log[0]["loss"],
                       run.metrics_log[-1]["loss"])
        print(f"loss {first:.3f} → {last:.3f} over {run.step} steps "
              f"({'OK' if last < first else 'NO IMPROVEMENT'})")
    return run


if __name__ == "__main__":
    main()
