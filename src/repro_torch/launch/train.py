"""Training on one device or across processes — counterpart of
``repro.launch.train``.

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

``--nproc N`` trains in N processes, one rank each, over
``torch.distributed`` (a ``--mesh`` of N ranks): each rank takes its block
of the batch and of the params by the ``--mode``'s rules
(``parallel.sharding``), the MoE runs expert-parallel over its model row,
the grads are summed over the ranks that hold other rows and averaged, and
each rank keeps its block of the optimizer state (ZeRO-1 in zero1 and
ep_dp); rank 0 prints and writes the checkpoint. ``--mode tp_sp`` (the
default) splits the heads, the vocabulary, the experts, the MLP's, SSM's
and RG-LRU's channels and the residual's sequence over the model axis
(``parallel.tp``), for every family the launcher trains. ``--dropless``
trains the MoE through the dropless fragment in every mode: each rank
gathers the whole batch and runs the fragment over it
(``launch.dropless.MeshRows``), ``--dropless-ep`` defaulting to the model
axis, as in the reference.
``main(fsdp=True)`` adds FSDP over ``data`` (the reference's launcher has
no flag for it either: its default turns it on above 10 B parameters).
``--backend nccl``, the default on the card, puts rank r on ``cuda:r`` and
raises when the machine has fewer cards than processes; ``--backend gloo``
runs every rank on ``--device``, CUDA tensors moving through host buffers
(several processes on one card), and is the default with ``--device cpu``.
The rendezvous is a file in a new temporary directory. ``--n-layers``
cuts the depth: four processes on one card share it, granite at its 32
layers takes most of a card in one process, and at 2 layers four
processes fit.
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --nproc 4 --mesh 2x2 --mode tp_sp --global-batch 4 --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --nproc 4 --mesh 2x2 --mode tp_sp --global-batch 4 --seq 16 \
        --steps 2 --arch recurrentgemma-2b
    PYTHONPATH=src python -m repro_torch.launch.train --nproc 4 --mesh 2x2 \
        --mode zero1 --backend gloo --n-layers 2 --seq 4096 \
        --global-batch 4 --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --nproc 4 --mesh 2x2 --mode ep_dp --dropless --global-batch 4 \
        --seq 16 --steps 2

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
import math
import os
import zlib
from typing import Optional

import torch

from ..convert import DistTrainLayout, JaxTrainLayout
from ..core.buckets import BucketSpec
from ..core.passes import pipeline_arg
from ..device import resolve_device
from ..data.pipeline import DataConfig, SyntheticStream
from ..ft.runner import FTConfig, train_loop
from ..kernels import gmm as gmm_kernel
from ..models import model as M
from ..optim import adamw
from ..parallel.ep import EPConfig
from ..parallel.sharding import own_params
from . import steps as St
from .dropless import DroplessConfig
from .mesh import dist_mesh, make_mesh, mesh_dims


@dataclasses.dataclass
class TrainRun:
    params: dict
    opt_state: dict
    # Per step (from 0; with --ckpt-dir the steps before a resume too):
    # step, loss, grad_norm, lr, step_ms, gmm_launches (and by fp32 body,
    # gmm_fp32_launches), peak_bytes (the card's peak so far; None off
    # the card), ssc_* when dropless, and
    # collectives and comm_bytes_per_rank with --mesh, and with --nproc
    # over gloo comm_seconds (each kind's transfers' host seconds).
    metrics_log: list
    dropless: object = None   # the DroplessMoE handle of a dropless run
    resumed_from: Optional[int] = None   # the checkpoint step resumed from
    # With --nproc: each rank's record (params and opt_state are None):
    # rank, coords, device, kernel launches, param and optimizer-state
    # bytes, peak device bytes, checkpoint log, its per_step gmm launches
    # and ssc_* counters and, with --ckpt-dir, its final blocks'
    # CRC32s; metrics_log is rank 0's, each step's record with
    # grad_leaf_norms (the reduced grads', adamw.tree_leaves order).
    ranks: Optional[list] = None


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


def main(argv=None, *, inject_fault=None, fsdp=None) -> TrainRun:
    """Parse ``argv`` and train. ``inject_fault(step)`` is called before
    each step and may raise to simulate a node loss. ``fsdp``: the
    reference's ``make_steps(fsdp=)`` (``None``: by the parameter count)."""
    args, cfg, dims, dropless = _parse(argv, fsdp)
    if args.nproc:
        return _spawn([(args, cfg, dropless)], inject_fault)[0]
    return _train(args, cfg, dims, dropless, inject_fault,
                  resolve_device(args.device))


def main_runs(argvs, *, fsdp=None) -> list:
    """Several ``--nproc`` runs in one spawn of their processes: each
    ``argv`` as :func:`main` takes it (``fsdp``: one a run, default
    ``None``), all with one ``--nproc``, ``--mesh``, ``--backend`` and
    ``--device``. Each process runs them in turn, each from fresh launch
    counts, peak memory and process-level SSC cache, as a spawn of its own
    would, without starting its processes again. Returns each run's
    :class:`TrainRun`, its ranks' records with their ``seconds``."""
    fsdp = list(fsdp or [None] * len(argvs))
    runs = [_parse(a, f) for a, f in zip(argvs, fsdp, strict=True)]
    first = runs[0][0]
    for args, *_ in runs:
        if not args.nproc or (args.nproc, args.mesh, backend_of(args),
                              args.device) != (
                first.nproc, first.mesh, backend_of(first), first.device):
            raise ValueError("main_runs shares one spawn: every run needs "
                             "the same --nproc, --mesh, --backend and "
                             "--device")
    return _spawn([(args, cfg, dropless) for args, cfg, _, dropless in runs],
                  None)


def _parse(argv, fsdp) -> tuple:
    """(args, cfg, mesh dims, DroplessConfig or None) of ``argv``,
    checked; a ``--nproc`` run's before any process starts."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite-moe-3b-a800m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-sized)")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the arch to this many layers (full width)")
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
    ap.add_argument("--nproc", type=int, default=0,
                    help="train in N processes, one rank each, over "
                         "torch.distributed (--mesh of N ranks; --mode "
                         "tp_sp, zero1 or ep_dp); default: one process")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="with --nproc: nccl (the default on the card, "
                         "rank r on cuda:r, one card a rank) or gloo (the "
                         "ranks on --device; CUDA tensors move through host "
                         "buffers; the default with --device cpu)")
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
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
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

    args.fsdp = fsdp
    if args.nproc:
        _check_processes(ap, args, dims)
    return args, cfg, dims, dropless


def _check_processes(ap, args, dims) -> None:
    """Refuse a ``--nproc`` run the port does not cover, before any
    process starts."""
    if dims is None or math.prod(dims) != args.nproc:
        ap.error(f"--nproc {args.nproc} needs a --mesh of {args.nproc} "
                 f"ranks")
    if args.global_batch % args.nproc:
        ap.error(f"--global-batch {args.global_batch} does not split over "
                 f"{args.nproc} processes")
    if backend_of(args) == "nccl":
        if not args.device.startswith("cuda"):
            ap.error("--backend nccl runs the ranks on the card: "
                     "--device cuda")
        n = torch.cuda.device_count()
        if args.nproc > n:
            raise RuntimeError(
                f"--backend nccl runs one rank a card: {args.nproc} "
                f"processes, {n} cards (NCCL refuses two ranks on one "
                f"card); --backend gloo runs them on --device over "
                f"host-staged transfers")


def backend_of(args) -> str:
    """``--backend``, by default NCCL on the card and gloo on the CPU."""
    if args.backend is not None:
        return args.backend
    return "gloo" if args.device == "cpu" else "nccl"


def _spawn(runs, inject_fault) -> list:
    """``nproc`` processes, one rank each, over a ``file://`` rendezvous
    in a new temporary directory, running each of ``runs`` (``(args, cfg,
    dropless)``, one ``--nproc``) in turn; returns, a run each, rank 0's
    log and every rank's record."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp
    nproc = runs[0][0].nproc
    d = tempfile.mkdtemp(prefix="train_nproc_")
    try:
        mp.start_processes(_rank_main, args=(
            runs, f"file://{os.path.join(d, 'init')}", d, inject_fault),
            nprocs=nproc, join=True, start_method="spawn")
        out = []
        for i in range(len(runs)):
            ranks = [torch.load(os.path.join(d, f"rank{r}_{i}.pt"),
                                weights_only=False) for r in range(nproc)]
            logs = [(r.pop("metrics_log"), r.pop("resumed_from"))
                    for r in ranks]
            out.append(TrainRun(params=None, opt_state=None,
                                metrics_log=logs[0][0],
                                resumed_from=logs[0][1], ranks=ranks))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return out


def _rank_main(rank, runs, init, out_dir, inject_fault) -> None:
    import time

    import torch.distributed as dist

    from . import dropless as dropless_mod
    first = runs[0][0]
    dist.init_process_group(backend_of(first), init_method=init,
                            world_size=first.nproc, rank=rank)
    try:
        dev = resolve_device(first.device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        # The ranks share the host's cores.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // first.nproc))
        for i, (args, cfg, dropless) in enumerate(runs):
            # Each run as a process of its own would start it.
            dropless_mod._PROCESS_CACHE = None
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
            t = time.perf_counter()
            run = _train(args, cfg, mesh_dims(args.mesh), dropless,
                         inject_fault, dev)
            rec = dict(run.ranks[0], metrics_log=run.metrics_log,
                       resumed_from=run.resumed_from,
                       seconds=time.perf_counter() - t)
            torch.save(rec, os.path.join(out_dir, f"rank{rank}_{i}.pt"))
            del run
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _kernel_launches(since=None) -> dict:
    """Each GMM kernel's launches, and those on the tensor cores; with
    ``since`` (an earlier reading), the launches after it."""
    from ..kernels import gmm_swiglu, gmm_swiglu_bwd
    now = {"gmm_swiglu": gmm_swiglu.launches, "gmm": gmm_kernel.launches,
           "gmm_swiglu_bwd": gmm_swiglu_bwd.launches,
           "tensor_cores": {"gmm_swiglu": gmm_swiglu.launches_tc,
                            "gmm": gmm_kernel.launches_tc,
                            "gmm_swiglu_bwd": gmm_swiglu_bwd.launches_tc}}
    if since is None:
        return now
    return {k: ({n: c - since[k][n] for n, c in v.items()}
                if isinstance(v, dict) else v - since[k])
            for k, v in now.items()}


def _gmm_counts() -> tuple:
    """``gmm``'s launches, all and by fp32 body (tiled, narrow,
    small-row)."""
    return (gmm_kernel.launches, gmm_kernel.launches_fp32_tiled,
            gmm_kernel.launches_fp32_narrow, gmm_kernel.launches_fp32_small)


def _crc32(tree) -> list:
    """Each tensor leaf's CRC32 over its bytes on the host."""
    return [zlib.crc32(t.detach().cpu().contiguous().view(torch.uint8)
                       .numpy()) for t in adamw.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _train(args, cfg, dims, dropless, inject_fault, dev) -> TrainRun:
    """The run of this process: the whole one with ``args.nproc`` 0, else
    this rank's (``torch.distributed`` initialized)."""
    oc = adamw.OptConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                         total_steps=args.steps)
    mesh, rules, layout = None, None, JaxTrainLayout
    if dims is None:
        step_fn = St.make_train_step(cfg, oc, dropless=dropless)
    else:
        mesh = dist_mesh(dims) if args.nproc else make_mesh(dims, dev)
        cfg = pad_experts(cfg, mesh.shape["model"])
        ep = EPConfig(mode=args.ep_mode or "hyperparallel",
                      capacity_factor=4.0)
        fns = St.make_steps(cfg, mesh, opt=oc, ep=ep,
                            mode=args.mode or "tp_sp", dropless=dropless,
                            fsdp=args.fsdp, global_batch=args.global_batch)
        step_fn = fns.train_step
    params = adamw.cast_params(
        M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                      device=dev), cfg.compute_dtype)
    if args.nproc:
        rules = fns.rules
        params = own_params(rules, params, mesh)
        opt_state = adamw.init_opt_state(params, rules, mesh)
        layout = DistTrainLayout(rules, mesh)
    else:
        opt_state = adamw.init_opt_state(params)
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                        global_batch=args.global_batch),
                             rules=rules)
    cuda = dev.type == "cuda"
    talk = not args.nproc or mesh.world.rank == 0
    launches, since = _gmm_counts(), _kernel_launches()
    if mesh is not None:
        mesh.comm.stats.reset()

    def on_step(s, m, dt):
        nonlocal launches
        now = _gmm_counts()
        rec = {"lr": m["lr"], "step_ms": 1e3 * dt,
               "gmm_launches": now[0] - launches[0],
               "gmm_fp32_launches": {"tiled": now[1] - launches[1],
                                     "narrow": now[2] - launches[2],
                                     "small": now[3] - launches[3]},
               "peak_bytes": (torch.cuda.max_memory_allocated(dev) if cuda
                              else None)}
        launches = now
        rec.update({k: v for k, v in m.items() if k.startswith("ssc_")})
        if mesh is not None:
            rec["collectives"] = dict(mesh.comm.stats.counts)
            rec["comm_seconds"] = dict(mesh.comm.stats.seconds)
            rec["comm_bytes_per_rank"] = mesh.comm.stats.bytes / (
                1 if args.nproc else mesh.dp_size)
            mesh.comm.stats.reset()
        if args.nproc:
            rec["grad_leaf_norms"] = m["grad_leaf_norms"].tolist()
        ssc = ("" if dropless is None else
               f" ssc hits {rec['ssc_hits']} misses {rec['ssc_misses']} "
               f"entries {rec['ssc_entries']} "
               f"pad {rec['ssc_pad_ratio']:.3f}")
        if talk:
            print(f"step {s:4d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} {1e3 * dt:.0f}ms{ssc}",
                  flush=True)
        return rec

    run = train_loop(
        step_fn=step_fn, params=params, opt_state=opt_state, stream=stream,
        mesh=mesh, device=dev, n_steps=args.steps,
        ft=FTConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
        inject_fault=inject_fault, log_every=1, layout=layout,
        on_step=on_step)
    if run.resumed_from is not None and talk:
        print(f"resumed from step {run.resumed_from}")
    if run.stragglers and talk:
        print("stragglers:", run.stragglers)
    if dropless is not None and talk:
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
    if not args.nproc:
        return TrainRun(params=run.params, opt_state=run.opt_state,
                        metrics_log=log, dropless=step_fn.dropless,
                        resumed_from=run.resumed_from)
    state = run.opt_state
    rank = {"rank": mesh.world.rank, "coords": mesh.coords,
            "device": str(dev), "launches": _kernel_launches(since),
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in adamw.tree_leaves(run.params)),
            "opt_state_bytes": sum(
                t.numel() * t.element_size() for k in ("m", "v", "master")
                for t in adamw.tree_leaves(state[k])),
            "peak_bytes": (torch.cuda.max_memory_allocated(dev) if cuda
                           else None),
            "ckpt_log": run.ckpt_log,
            # This rank's own gmm launches and SSC counters (dropless) a
            # step.
            "per_step": [{k: v for k, v in m.items()
                          if k.startswith(("ssc_", "gmm_"))} for m in log]}
    if args.ckpt_dir is not None:
        # What this rank saved last (the final state when the last step
        # saved): its blocks' CRC32s, leaf by leaf.
        rank["state_crc32"] = {"params": _crc32(run.params), **{
            k: _crc32(state[k]) for k in ("m", "v", "master")}}
    return TrainRun(params=None, opt_state=None, metrics_log=log,
                    resumed_from=run.resumed_from, ranks=[rank])


if __name__ == "__main__":
    main()
