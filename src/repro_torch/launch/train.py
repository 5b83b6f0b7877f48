"""Training on one device — counterpart of ``repro.launch.train``.

On the card (the default), granite-moe-3b-a800m at full width and depth on
4096-token batches:
    PYTHONPATH=src python -m repro_torch.launch.train --seq 4096 \\
        --global-batch 1 --steps 4
On the CPU, at the smoke size:
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
``--arch`` takes every arch of ``repro_torch.configs.ARCHS`` but the audio
encoder: the dense (llama3_2-3b, qwen2-1_5b, olmo-1b, gemma-2b), ssm
(mamba2-1_3b), hybrid (recurrentgemma-2b) and vlm (internvl2-26b, trained
on tokens alone, as the reference's launcher trains it) families as well as
the MoE ones. hubert-xlarge raises ``ValueError``: the launcher feeds token
batches, and it trains on ``features`` through
``launch.steps.make_train_step``. For an arch without
MoE layers ``--dropless`` is ignored and ``--sched`` is a usage error, as in
the JAX launcher:
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \
        --smoke --device cpu --steps 3
``--dropless`` trains the MoE through each batch's compiled tile taskflow
(``launch.dropless``; ``--dropless-ep``, ``--dropless-bucket`` and
``--sched`` as in the JAX launcher):
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --dropless --steps 3
``--mesh DxM`` (or ``PxDxM``) runs the steps of ``launch.steps.make_steps``
over a mesh of virtual ranks on the one device: the MoE expert-parallel over
the model axis (``--ep-mode hyperparallel`` or ``baseline``, capacity factor
4.0, the experts padded so the axis divides them), the batch built data
group by data group; ``--mode`` as in the JAX launcher:
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --mesh 1x4 --ep-mode baseline --steps 3

Params come from ``init_params`` (seed 0), cast to the compute dtype as the
JAX launcher casts them; batches from ``SyntheticStream``. Each step logs
its loss, grad norm, host-clock ms (the step ends by waiting for the
device), the ``gmm`` kernel launches it made and, on the card, the peak
device memory so far; a dropless step also its ``ssc_*`` cache counters.

The steps run through ``ft.runner.train_loop``. ``--ckpt-dir D`` resumes
from D's newest complete checkpoint, in place (printing ``resumed from step
N``, as the JAX launcher does), saves every ``--ckpt-every`` steps (default
10) and at the last step in the JAX package's layout
(``convert.JaxTrainLayout``: either package restores the other's), and
keeps the newest 3; the log of the steps before the resume comes back with
it. Without ``--ckpt-dir`` nothing is saved or resumed: the JAX launcher's
default directory under ``/tmp`` would make each run resume from the one
before it.
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --steps 6 --ckpt-dir ckpt --ckpt-every 2
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import torch

from ..convert import JaxTrainLayout
from ..core.buckets import BucketSpec
from ..core.passes import pipeline_arg
from ..device import resolve_device
from ..data.pipeline import DataConfig, SyntheticStream
from ..ft.runner import FTConfig, train_loop
from ..kernels import gmm as gmm_kernel
from ..models import model as M
from ..optim import adamw
from ..parallel.ep import EPConfig
from . import steps as St
from .dropless import DroplessConfig
from .mesh import make_mesh, mesh_dims


@dataclasses.dataclass
class TrainRun:
    params: dict
    opt_state: dict
    # Per step (from 0; with --ckpt-dir the steps before a resume too):
    # step, loss, grad_norm, lr, step_ms, gmm_launches, peak_bytes (the
    # card's peak so far; None off the card), ssc_* when dropless, and
    # collectives and comm_bytes_per_rank with --mesh.
    metrics_log: list
    dropless: object = None   # the DroplessMoE handle of a dropless run
    resumed_from: Optional[int] = None   # the checkpoint step resumed from


def pad_experts(cfg, ep: int):
    """``cfg`` with its experts padded so that ``ep`` divides them (the
    router never selects padding)."""
    if cfg.family != "moe":
        return cfg
    extra = (-cfg.moe.e_total) % ep
    if not extra:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_padding_experts=cfg.moe.n_padding_experts + extra))


def main(argv=None, *, inject_fault=None) -> TrainRun:
    """Parse ``argv`` and train. ``inject_fault(step)`` is called before
    each step and may raise to simulate a node loss."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite-moe-3b-a800m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dropless", action="store_true",
                    help="compile/reuse schedules from each batch's actual "
                         "router output (capacity=None) instead of running "
                         "the fixed-capacity path")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="dataxmodel (or podxdataxmodel) virtual ranks on "
                         "the device; the MoE runs expert-parallel over "
                         "model")
    ap.add_argument("--mode", default=None, choices=St.MODES,
                    help="the reference's parallel mode (needs --mesh; "
                         "ep_dp shards tokens over every axis)")
    ap.add_argument("--ep-mode", default=None,
                    choices=["hyperparallel", "baseline"],
                    help="EP dispatch (needs --mesh; default hyperparallel)")
    ap.add_argument("--dropless-ep", type=int, default=0,
                    help="EP group size of the compiled dropless fragment "
                         "(virtual ranks on the one device; 0 = the "
                         "mesh's model-axis size, 1 without --mesh)")
    ap.add_argument("--dropless-bucket", default="16", metavar="SPEC",
                    help="shape-bucket policy for plan row counts: a linear "
                         "bucket size int ('16'; '1' = exact plans), "
                         "'geometric:B[xG]' or 'ladder:E1,E2,...'; see "
                         "repro_torch.core.buckets.BucketSpec")
    ap.add_argument("--sched", default=None, metavar="PIPELINE",
                    help="schedule-pass pipeline for the dropless path: "
                         "'auto', a named core.passes.SCHED_PIPELINES entry "
                         "(e.g. 'ratr+crit'), or a comma-separated pass "
                         "list; default keeps the DroplessConfig default")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory: resume from its newest "
                         "complete checkpoint and save into it (default: "
                         "none, nothing saved or resumed)")
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="steps between checkpoints (default 10; needs "
                         "--ckpt-dir)")
    args = ap.parse_args(argv)
    if args.ckpt_every is not None:
        if args.ckpt_dir is None:
            ap.error("--ckpt-every needs --ckpt-dir")
        if args.ckpt_every < 1:
            ap.error("--ckpt-every must be at least 1")
    else:
        args.ckpt_every = 10

    dims = None
    if args.mesh is not None:
        try:
            dims = mesh_dims(args.mesh)
        except ValueError as e:
            ap.error(str(e))
    elif args.mode or args.ep_mode:
        ap.error("--mode and --ep-mode need --mesh")
    from ..configs import get_config, get_smoke_config
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "audio":
        raise ValueError(
            f"{cfg.name!r} trains on features, and this launcher feeds "
            f"token batches (as the reference's does): train it through "
            f"launch.steps.make_train_step on a features batch")
    kw = {}
    if args.sched is not None:
        # Validate eagerly: an unknown pass name fails fast, and a --sched
        # that cannot take effect says so instead of training with defaults.
        try:
            kw["pipeline"] = pipeline_arg(args.sched)
        except KeyError as e:
            ap.error(str(e))
        if not args.dropless:
            ap.error("--sched only applies to the dropless scheduling path; "
                     "add --dropless")
        if cfg.family != "moe":
            ap.error(f"--sched requires a MoE arch (got {args.arch!r}: "
                     f"family={cfg.family!r})")
    dropless = None
    # As in the JAX launcher, --dropless is ignored for an arch without
    # MoE layers.
    if args.dropless and cfg.family == "moe":
        try:
            bucket = BucketSpec.parse(args.dropless_bucket)
        except ValueError as e:
            ap.error(str(e))
        dropless = DroplessConfig(
            ep=args.dropless_ep or (dims[-1] if dims else 1), bucket=bucket,
            **kw)
        print(f"dropless shape buckets: {bucket}")
        if kw:
            print(f"dropless schedule pipeline: {dropless.pipeline!r}")

    dev = resolve_device(args.device)
    oc = adamw.OptConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                         total_steps=args.steps)
    mesh = None
    if dims is None:
        step_fn = St.make_train_step(cfg, oc, dropless=dropless)
    else:
        mesh = make_mesh(dims, dev)
        cfg = pad_experts(cfg, mesh.shape["model"])
        ep = EPConfig(mode=args.ep_mode or "hyperparallel",
                      capacity_factor=4.0)
        step_fn = St.make_steps(cfg, mesh, opt=oc, ep=ep,
                                mode=args.mode or "tp_sp",
                                dropless=dropless).train_step
    params = adamw.cast_params(
        M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                      device=dev), cfg.compute_dtype)
    opt_state = adamw.init_opt_state(params)
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                        global_batch=args.global_batch))
    cuda = dev.type == "cuda"
    launches = gmm_kernel.launches
    if mesh is not None:
        mesh.comm.stats.reset()

    def on_step(s, m, dt):
        nonlocal launches
        rec = {"lr": m["lr"], "step_ms": 1e3 * dt,
               "gmm_launches": gmm_kernel.launches - launches,
               "peak_bytes": (torch.cuda.max_memory_allocated(dev) if cuda
                              else None)}
        launches = gmm_kernel.launches
        rec.update({k: v for k, v in m.items() if k.startswith("ssc_")})
        if mesh is not None:
            rec["collectives"] = dict(mesh.comm.stats.counts)
            rec["comm_bytes_per_rank"] = mesh.comm.stats.bytes / mesh.dp_size
            mesh.comm.stats.reset()
        ssc = ("" if dropless is None else
               f" ssc hits {rec['ssc_hits']} misses {rec['ssc_misses']} "
               f"entries {rec['ssc_entries']} "
               f"pad {rec['ssc_pad_ratio']:.3f}")
        print(f"step {s:4d} loss {float(m['loss']):.4f} "
              f"gnorm {float(m['grad_norm']):.3f} {1e3 * dt:.0f}ms{ssc}",
              flush=True)
        return rec

    run = train_loop(
        step_fn=step_fn, params=params, opt_state=opt_state, stream=stream,
        mesh=mesh, device=dev, n_steps=args.steps,
        ft=FTConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
        inject_fault=inject_fault, log_every=1, layout=JaxTrainLayout,
        on_step=on_step)
    if run.resumed_from is not None:
        print(f"resumed from step {run.resumed_from}")
    if run.stragglers:
        print("stragglers:", run.stragglers)
    if dropless is not None:
        info = step_fn.dropless.cache.info()
        total = max(1, info["hits"] + info["misses"])
        print(f"dropless SSC cache: {info['entries']} entries "
              f"({info['bytes'] / 1024:.0f} KiB), "
              f"hit rate {info['hits'] / total:.1%} "
              f"({info['misses']} compiles, {info['evictions']} evictions)")
    # One record a step, numbered by the step that made it (from 0), the
    # steps before a resume included.
    log = [dict({k: v for k, v in m.items() if k != "step_time_s"},
                step=m["step"] - 1) for m in run.metrics_log]
    return TrainRun(params=run.params, opt_state=run.opt_state,
                    metrics_log=log, dropless=step_fn.dropless,
                    resumed_from=run.resumed_from)


if __name__ == "__main__":
    main()
