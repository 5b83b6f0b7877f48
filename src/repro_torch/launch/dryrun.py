"""Dry run: count every (arch × shape) cell's step on the meta device —
counterpart of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.json

It runs on any machine, without a card: nothing is allocated or computed.
The reference lowers and compiles each cell with XLA and reads its cost
analysis (``lower_cell``); :func:`count_cell` takes its place. It runs the
cell's real step on the meta device inside ``parallel.roofline.WorkCounter``:
``train_step`` with autograd, per-layer remat and the AdamW update (the
launcher's microbatch policy included), ``prefill_step``, or
``decode_step`` over ``cache_specs``. The grouped-GEMM wrappers report
their kernels' own work there (``kernels/work.py``).

Two differences from the reference:

* one card, mesh ``1x1``: the reference's 256- and 512-chip production
  meshes wait for the port's multi-card work (``launch/mesh.py`` has no
  ``make_production_mesh``), so a cell's per-device numbers here are the
  whole step's;
* no 2- and 3-trip extrapolation: XLA's cost analysis visits a scanned
  layer stack's body once, so the reference compiles unrolled probes and
  extrapolates, while the port's Python loop runs every layer and the count
  is whole.

A vlm prefill's cache holds the patches too: its ``max_len`` is the
sequence plus ``n_patches``. ``--workers N`` counts the cells in N spawned
processes, the most work first (a cell's count is host work on one core).
"""

from __future__ import annotations

import argparse
import json
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
from . import steps as St
from .mesh import make_mesh

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


def count_cell(cfg, shape):
    """Run one cell's step on the meta device under a ``WorkCounter``.

    ``shape`` is a name of ``SHAPES`` or a ``ShapeSpec`` (a cell cut to a
    run's batch and sequence). Returns (``Roofline``, seconds).
    """
    sp = _spec(shape)
    t0 = time.perf_counter()
    mesh = make_mesh((1, 1), "meta")
    fns = St.make_steps(cfg, mesh)
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
    rf = R.Roofline(
        arch=cfg.name, shape=sp.name, mesh="1x1", chips=1,
        flops_per_device=float(wc.flops), bytes_per_device=float(wc.bytes),
        collective_bytes=0.0, model_flops_global=float(model_flops(cfg, sp)),
        arg_bytes=float(arg_bytes), temp_bytes=float(wc.peak_live_bytes),
        coll_counts={}, model_bytes_global=float(model_bytes(cfg, sp)),
        dtype=cfg.dtype, kernels=wc.kernels)
    return rf, dt


def _count_row(cfg, shape):
    """One cell: (its row, None), or (None, its failure)."""
    try:
        rf, dt = count_cell(cfg, shape)
    except Exception as e:  # noqa: BLE001 -- reported, the run goes on
        return None, (cfg.name, _spec(shape).name, "1x1", repr(e))
    return {**rf.row(), "count_s": dt}, None


def _ops_estimate(cell) -> int:
    """A cell's count takes time by its ops, not its sizes: layers, times
    microbatches and three passes (forward, recompute, backward) for a
    train step (the launcher's microbatch policy)."""
    cfg, shape = cell
    if _spec(shape).kind != "train":
        return cfg.n_layers
    n = cfg.param_count()
    return 3 * cfg.n_layers * (8 if n > 100e9 else 4 if n > 10e9 else 1)


def count_all(cells, workers: int = 1) -> list:
    """``(row, None)`` or ``(None, failure)`` of each ``(cfg, shape)`` cell,
    in order; with ``workers`` > 1 in spawned processes, the most ops
    first."""
    if workers <= 1:
        return [_count_row(*c) for c in cells]
    order = sorted(range(len(cells)), key=lambda i: -_ops_estimate(cells[i]))
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(workers, len(cells))) as pool:
        done = pool.starmap(_count_row, [cells[i] for i in order],
                            chunksize=1)
    results = [None] * len(cells)
    for i, r in zip(order, done):
        results[i] = r
    return results


def run_all(archs, shapes, *, out=None, workers: int = 1):
    """Count every cell of ``archs`` × ``shapes`` that ``skip_reason``
    keeps, in ``workers`` processes. Returns (rows, failures) in the
    cells' order; ``out`` gets them as JSON."""
    todo = []
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in shapes:
            why = skip_reason(cfg, shape_name)
            if why:
                print(f"SKIP {arch} × {shape_name}: {why}")
            else:
                todo.append((cfg, shape_name))
    t0 = time.perf_counter()
    results = count_all(todo, workers)
    rows, failures = [], []
    for (cfg, shape_name), (row, fail) in zip(todo, results):
        print(f"RUN  {cfg.name} × {shape_name} × 1x1")
        if fail is not None:
            failures.append(fail)
            print(f"  FAIL: {fail[-1]}")
            continue
        rows.append(row)
        print(f"  roofline: compute={row['t_compute_s'] * 1e3:.2f}ms "
              f"memory={row['t_memory_s'] * 1e3:.2f}ms "
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="every arch and shape (the default without "
                         "--arch/--shape)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--workers", type=int, default=1,
                    help="processes counting cells at once")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else DRYRUN_ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    return run_all(archs, shapes, out=args.out, workers=args.workers)


if __name__ == "__main__":
    sys.exit(1 if main()[1] else 0)
