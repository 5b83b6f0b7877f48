"""Dry run: count every (arch × shape) cell's step on the meta device —
counterpart of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mode zero1 --workers 6
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod-only --out dry.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 1x1 --out dryrun.json

It runs on any machine, without a card: nothing is allocated or computed.
The reference lowers and compiles each cell with XLA on its production
meshes and reads its cost analysis (``lower_cell``); :func:`count_cell`
takes its place. It runs the cell's real step on the meta device inside
``parallel.roofline.WorkCounter``: ``train_step`` with autograd, per-layer
remat and the AdamW update (the launcher's microbatch policy included),
``prefill_step``, or ``decode_step`` over ``cache_specs``. The
grouped-GEMM wrappers report their kernels' own work there
(``kernels/work.py``).

The meshes, as the reference's ``--single-pod-only``/``--multi-pod-only``
choose them (both by default): ``make_production_mesh``'s 16x16 (256
chips) and 2x16x16 (512 chips), in the mode ``--mode`` names (tp_sp, zero1
or ep_dp) with the MoE's ``EPConfig(mode=--ep-mode)``, FSDP above 10e9
params and the microbatch policy, as the reference's ``_compile_step``
sets them. A production mesh is a counting process mesh
(``launch.mesh.counting_mesh``): the count is rank 0's program of the
port's process-mesh step (``launch.steps``), on its blocks of the params,
the optimizer state and the batch, its transfers counted and not made
(``parallel.comm.CountingComm``). Its numbers are that rank's: FLOPs and
bytes, argument and temporary bytes, and collectives and bytes of every
transfer it makes, the backward's and the optimizer's included, priced
at NVLink's 450 GB/s on every axis (a prediction, not a multi-node link).
A serving cell is rank 0's prefill of the cell's prompt into its cache
blocks, or its decode step over its ``cache_spec`` blocks of the cell's
cache (``launch.steps`` on a process mesh, flash decoding where the model
axis splits the slots). ``--mesh 1x1`` is the one-card count of every
cell, a step's whole work; ``--mesh DxM`` counts rank 0 of another
counting mesh.

Differences from the reference:

* rank 0's program, not a per-device average over a compiled SPMD
  program: where the work does not split evenly (query heads that the
  model axis does not split, ``parallel.tp``), rank 0 is the busiest;
* the collective bytes are the rank's transfers, the backward's
  included, as the reference's come from the whole step's HLO;
* the microbatch policy splits a rank's rows, where the reference splits
  the global batch: a rank with fewer rows than microbatches takes none
  (the FLOPs are the same, the counted peak is not);
* no 2- and 3-trip extrapolation: XLA's cost analysis visits a scanned
  layer stack's body once, so the reference compiles unrolled probes and
  extrapolates, while the port's Python loop runs every layer and the count
  is whole.

``count_cell(mesh=)`` also takes a mesh of virtual ranks
(``launch/hillclimb.py`` counts on ``1x4``): the FLOPs and bytes are
then the whole step's, and the collectives and bytes a rank come from the
ranks' forward counts. A vlm prefill's cache holds the patches too: its
``max_len`` is the sequence plus ``n_patches``. ``--workers N`` counts the
cells in N spawned processes, the most work first (a cell's count is host
work on one core).
"""

from __future__ import annotations

import argparse
import json
import math
import multiprocessing
import sys
import time

import torch

from ..configs import ARCHS, get_config
from ..configs.shapes import (SHAPES, ShapeSpec, cache_specs, input_specs,
                              skip_reason)
from ..models import model as M
from ..optim import adamw
from ..parallel import roofline as R
from ..parallel.ep import EPConfig
from ..parallel.sharding import batch_block, cache_blocks, own_params
from . import steps as St
from .mesh import counting_mesh, make_mesh, mesh_dims

# The reference's production meshes: name -> make_production_mesh's
# multi_pod.
PRODUCTION = {"16x16": False, "2x16x16": True}
EP_MODES = ("hyperparallel", "baseline")

# The reference's ten architectures (the port's registry adds the paper's
# module, which is no cell of the grid).
DRYRUN_ARCHS = [a for a in ARCHS if a != "deepseek-moe-paper"]


def _spec(shape) -> ShapeSpec:
    return SHAPES[shape] if isinstance(shape, str) else shape


def model_flops(cfg, shape) -> float:
    """6·N·D for a train step, 2·N·D otherwise (N active params)."""
    sp = _spec(shape)
    n_active = cfg.active_param_count()
    tokens = sp.global_batch * (sp.seq_len if sp.kind != "decode" else 1)
    mult = 6 if sp.kind == "train" else 2
    return mult * n_active * tokens


def model_bytes(cfg, shape) -> float:
    """Least HBM traffic a step needs: parameter reads, optimizer-state
    read + write for train, the full cache read for decode."""
    sp = _spec(shape)
    n = cfg.param_count()
    if sp.kind == "train":
        # bf16 params read (fwd+bwd ≈ 2 passes) + grads rw + m/v/master rw.
        return n * (2 * 2 + 2 * 4 + 2 * 3 * 4)
    total = 2.0 * n
    if sp.kind == "decode":
        total += R.tree_bytes(cache_specs(cfg, sp))
    return total


def lookup_flops(cfg, shape) -> float:
    """The part of :func:`model_flops` that no step multiplies: 6·N·D
    (2·N·D) counts every parameter once a token, but an untied embedding
    table is a lookup, and a prefill takes the logits of each sequence's
    last position only, as the reference's does (an audio encoder's
    prefill is its forward, all positions)."""
    sp = _spec(shape)
    tokens = sp.global_batch * (sp.seq_len if sp.kind != "decode" else 1)
    rows = 0 if cfg.tie_embeddings else tokens
    if sp.kind == "prefill" and cfg.family != "audio":
        rows += tokens - sp.global_batch
    return ((6 if sp.kind == "train" else 2) * cfg.padded_vocab
            * cfg.d_model * rows)


def mesh_name(mesh) -> str:
    """``"DxM"`` (or ``"PxDxM"``) of a mesh."""
    return "x".join(str(n) for n in mesh.shape.values())


def step_policy(cfg, mode: str = "tp_sp",
                ep_mode: str = "hyperparallel") -> dict:
    """``make_steps`` keywords of a cell as the reference's dry run sets
    them (``_compile_step``): the mode, EP for the MoE, FSDP above 10e9
    params, 8 microbatches above 100e9 and 4 above 10e9."""
    n = cfg.param_count()
    return {"mode": mode,
            "ep": EPConfig(mode=ep_mode) if cfg.family == "moe" else None,
            "fsdp": n > 10e9,
            "accum_steps": 8 if n > 100e9 else (4 if n > 10e9 else 1)}


def count_cell(cfg, shape, mesh=None, **step_kw):
    """Run one cell's step on the meta device under a ``WorkCounter``.

    ``shape`` is a name of ``SHAPES`` or a ``ShapeSpec`` (a cell cut to a
    run's batch and sequence). ``mesh`` (default ``1x1``) is a mesh of
    virtual ranks on the meta device, or a counting process mesh
    (``launch.mesh.counting_mesh``, ``make_production_mesh``), whose
    rank's program is counted (``_count_rank``); ``step_kw`` go to
    ``launch.steps.make_steps`` (``ep``, ``mode``, ``fsdp``,
    ``flash_decode``, ...). The collectives and bytes a rank are read from
    ``mesh.comm.stats`` around the step. Returns (``Roofline``, seconds).
    """
    sp = _spec(shape)
    t0 = time.perf_counter()
    mesh = mesh or make_mesh((1, 1), "meta")
    if mesh.local_rows:
        return _count_rank(cfg, sp, mesh, t0, step_kw)
    fns = St.make_steps(cfg, mesh, **step_kw)
    mesh.comm.stats.reset()
    batch = input_specs(cfg, sp)
    params = M.init_params(cfg, device="meta")
    if sp.kind == "train":
        params = adamw.cast_params(params, cfg.compute_dtype)
        opt_state = adamw.init_opt_state(params)
        args = (params, opt_state, batch)
        arg_bytes = R.tree_bytes(args)
        with R.WorkCounter() as wc:
            fns.train_step(*args)
    else:
        if sp.kind == "prefill":
            max_len = sp.seq_len + (cfg.n_patches if "patches" in batch
                                    else 0)
            args = (params, batch)
            run = lambda: fns.prefill_step(params, batch, max_len)  # noqa
        else:
            cache = cache_specs(cfg, sp)
            args = (params, batch, cache)
            run = lambda: fns.decode_step(params, batch["tokens"], cache)  # noqa
        arg_bytes = R.tree_bytes(args)
        with torch.no_grad(), R.WorkCounter() as wc:
            run()
    dt = time.perf_counter() - t0
    # Each data group runs the model axis' program once: a rank's share.
    stats, groups = mesh.comm.stats, mesh.dp_size
    rf = R.Roofline(
        arch=cfg.name, shape=sp.name, mesh=mesh_name(mesh), chips=1,
        flops_per_device=float(wc.flops), bytes_per_device=float(wc.bytes),
        collective_bytes=stats.bytes / groups,
        model_flops_global=float(model_flops(cfg, sp)),
        arg_bytes=float(arg_bytes), temp_bytes=float(wc.peak_live_bytes),
        coll_counts={k: n // groups for k, n in sorted(stats.counts.items())},
        model_bytes_global=float(model_bytes(cfg, sp)),
        dtype=cfg.dtype, kernels=wc.kernels)
    return rf, dt


def _count_rank(cfg, sp, mesh, t0, step_kw):
    """``count_cell`` on a counting process mesh: rank ``mesh.coords``'s
    step on its blocks of the params and the batch (``global_batch``
    rows): a train step with its optimizer state's blocks, a prefill of
    the cell's prompt into the rank's cache blocks (``max_len`` as
    :func:`count_cell` takes it), or a decode step over the rank's
    ``cache_spec`` blocks of ``cache_specs``' cache."""
    fns = St.make_steps(cfg, mesh, global_batch=sp.global_batch, **step_kw)
    rules = fns.rules
    params = M.init_params(cfg, device="meta")
    batch = {k: v.clone() for k, v in
             batch_block(rules, input_specs(cfg, sp), mesh).items()}
    if sp.kind == "train":
        params = own_params(rules, adamw.cast_params(
            params, cfg.compute_dtype), mesh)
        opt_state = adamw.init_opt_state(params, rules, mesh)
        args = (params, opt_state, batch)
        run = lambda: fns.train_step(*args)  # noqa: E731
    elif sp.kind == "prefill":
        params = own_params(rules, params, mesh)
        max_len = sp.seq_len + (cfg.n_patches if "patches" in batch else 0)
        args = (params, batch)
        run = lambda: fns.prefill_step(  # noqa: E731
            params, batch, max_len, prompt_len=sp.seq_len)
    else:
        params = own_params(rules, params, mesh)
        cache = cache_blocks(rules, sp.global_batch, sp.seq_len, mesh,
                             "meta")
        args = (params, batch, cache)
        run = lambda: fns.decode_step(  # noqa: E731
            params, batch["tokens"], cache, max_len=sp.seq_len)
    arg_bytes = R.tree_bytes(args)
    stats = mesh.comm.stats
    stats.reset()
    with torch.set_grad_enabled(sp.kind == "train"), R.WorkCounter() as wc:
        run()
    dt = time.perf_counter() - t0
    rf = R.Roofline(
        arch=cfg.name, shape=sp.name, mesh=mesh_name(mesh),
        chips=math.prod(mesh.shape.values()),
        flops_per_device=float(wc.flops), bytes_per_device=float(wc.bytes),
        collective_bytes=float(sum(stats.transfer_bytes.values())),
        model_flops_global=float(model_flops(cfg, sp)),
        arg_bytes=float(arg_bytes), temp_bytes=float(wc.peak_live_bytes),
        coll_counts=dict(sorted(stats.transfers.items())),
        model_bytes_global=float(model_bytes(cfg, sp)),
        dtype=cfg.dtype, kernels=wc.kernels,
        coll_forward={"counts": dict(sorted(stats.counts.items())),
                      "bytes": stats.bytes})
    return rf, dt


def count_job(cfg, shape, mesh: str = "1x1", mode: str = "tp_sp",
              ep_mode: str = "hyperparallel"):
    """One cell on the mesh named ``mesh`` (``"1x1"``: the one-card count;
    a production mesh's name or any other ``DxM``: rank 0 of a counting
    mesh, with ``step_policy``'s keywords): (its row, None), or (None, its
    failure). A module-level function, for ``count_all``'s workers."""
    try:
        if mesh == "1x1":
            rf, dt = count_cell(cfg, shape)
        else:
            rf, dt = count_cell(cfg, shape, counting_mesh(mesh_dims(mesh)),
                                **step_policy(cfg, mode, ep_mode))
    except Exception as e:  # noqa: BLE001 -- reported, the run goes on
        return None, (cfg.name, _spec(shape).name, mesh, repr(e))
    # The least FLOPs the devices must do together: every product of the
    # step but the lookups (``lookup_flops``).
    row = {**rf.row(), "count_s": dt,
           "flops_floor": rf.model_flops_global - lookup_flops(cfg, shape)}
    if mesh != "1x1":
        row.update(mode=mode, ep_mode=ep_mode)
    return row, None


def _ops_estimate(cell) -> int:
    """A cell's count takes time by its ops, not its sizes: layers, times
    microbatches and three passes (forward, recompute, backward) for a
    train step (the launcher's microbatch policy)."""
    cfg, shape = cell[:2]
    if _spec(shape).kind != "train":
        return cfg.n_layers
    return 3 * cfg.n_layers * step_policy(cfg)["accum_steps"]


def count_all(cells, workers: int = 1, fn=None) -> list:
    """``(row, None)`` or ``(None, failure)`` of each ``(cfg, shape)`` cell,
    in order; with ``workers`` > 1 in spawned processes, the most ops
    first. ``fn(*cell)`` (a module-level function, default
    :func:`count_job`) counts one cell whose first two items are its
    config and shape."""
    fn = fn or count_job
    if workers <= 1:
        return [fn(*c) for c in cells]
    order = sorted(range(len(cells)), key=lambda i: -_ops_estimate(cells[i]))
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(workers, len(cells))) as pool:
        done = pool.starmap(fn, [cells[i] for i in order], chunksize=1)
    results = [None] * len(cells)
    for i, r in zip(order, done):
        results[i] = r
    return results


def meshes_of(mesh=None, *, single_pod_only: bool = False,
              multi_pod_only: bool = False) -> list:
    """The names of the meshes a run counts on: ``mesh`` alone, or the
    production meshes the reference's flags keep."""
    if mesh is not None:
        return ["x".join(map(str, mesh_dims(mesh)))]
    return [name for name, multi in PRODUCTION.items()
            if not (multi and single_pod_only)
            and not (not multi and multi_pod_only)]


def run_all(archs, shapes, *, out=None, workers: int = 1, mesh=None,
            mode: str = "tp_sp", ep_mode: str = "hyperparallel",
            single_pod_only: bool = False, multi_pod_only: bool = False):
    """Count every cell of ``archs`` × ``shapes`` that ``skip_reason``
    keeps on each mesh of ``meshes_of``, in ``workers`` processes.
    Returns (rows, failures) in the cells' order; ``out`` gets them as
    JSON."""
    names = meshes_of(mesh, single_pod_only=single_pod_only,
                      multi_pod_only=multi_pod_only)
    todo = []
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in shapes:
            why = skip_reason(cfg, shape_name)
            if why:
                print(f"SKIP {arch} × {shape_name}: {why}")
                continue
            for name in names:
                todo.append((cfg, shape_name, name, mode, ep_mode))
    t0 = time.perf_counter()
    results = count_all(todo, workers, count_job)
    rows, failures = [], []
    for (cfg, shape_name, name, *_), (row, fail) in zip(todo, results):
        print(f"RUN  {cfg.name} × {shape_name} × {name}"
              + ("" if name == "1x1" else f" ({mode}, {ep_mode})"))
        if fail is not None:
            failures.append(fail)
            print(f"  FAIL: {fail[-1]}")
            continue
        rows.append(row)
        share = row["flops_per_dev"] * row["chips"] / max(row["flops_floor"],
                                                          1.0)
        print(f"  flops/dev x chips / floor = {share:.3f}"
              + ("" if SHAPES[shape_name].kind == "decode" or share >= 1
                 else "  BELOW THE FLOOR"))
        print(f"  args={row['hbm_args_gb']:.2f}GiB "
              f"temp={row['hbm_temp_gb']:.2f}GiB "
              f"flops/dev={row['flops_per_dev']:.3e} "
              f"collectives={row['collectives']} "
              f"bytes/dev={row['collective_bytes_per_dev']:.3e}")
        print(f"  roofline: compute={row['t_compute_s'] * 1e3:.2f}ms "
              f"memory={row['t_memory_s'] * 1e3:.2f}ms "
              f"collective={row['t_collective_s'] * 1e3:.2f}ms "
              f"→ {row['bottleneck']}-bound, "
              f"frac={row['roofline_frac']:.3f}; OK in "
              f"{row['count_s']:.1f}s")
    print(f"wall {time.perf_counter() - t0:.1f}s")
    if out:
        with open(out, "w") as f:
            json.dump({"rows": rows,
                       "failures": [list(f_) for f_ in failures]}, f,
                      indent=1, default=str)
        print(f"wrote {out}")
    print(f"\n{len(rows)} cells counted, {len(failures)} failures")
    for f_ in failures:
        print("FAILED:", *f_[:3])
    return rows, failures


def build_parser() -> argparse.ArgumentParser:
    """The CLI: the reference's flags, and ``--mesh`` and ``--workers``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="every arch and shape (the default without "
                         "--arch/--shape)")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--ep-mode", default="hyperparallel",
                    choices=list(EP_MODES))
    ap.add_argument("--mode", default="tp_sp", choices=list(St.MODES),
                    help="sharding-rule mode")
    ap.add_argument("--mesh", default=None,
                    help="one mesh instead of the production ones: 1x1 "
                         "(the one-card count of every cell), or a DxM "
                         "counting mesh's rank 0")
    ap.add_argument("--out", default=None)
    ap.add_argument("--workers", type=int, default=1,
                    help="processes counting cells at once")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    archs = [args.arch] if args.arch else DRYRUN_ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    return run_all(archs, shapes, out=args.out, workers=args.workers,
                   mesh=args.mesh, mode=args.mode, ep_mode=args.ep_mode,
                   single_pod_only=args.single_pod_only,
                   multi_pod_only=args.multi_pod_only)


if __name__ == "__main__":
    sys.exit(1 if main()[1] else 0)
