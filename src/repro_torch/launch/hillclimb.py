"""Hill-climb loop: count a cell's step under named variants and print the
three roofline terms of each — counterpart of ``repro.launch.hillclimb``.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell granite_train
    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell llama_decode \\
        --variants baseline,flashdecode_off --out rows.json
    PYTHONPATH=src python -m repro_torch.launch.hillclimb --sched-sweep --ep 4

It runs on any machine, without a card. The reference lowers each variant
with XLA on its 16x16 production mesh and reads its cost analysis; the port
runs the variant's real step on the meta device through the dry run's
counter (``launch.dryrun.count_cell``). ``--mesh`` (default ``16x16``)
names the mesh: ``16x16`` or ``2x16x16`` count rank 0's program of the
process-mesh step on ``make_production_mesh``'s counting mesh, as the dry
run counts its cells there (FSDP above 10e9 parameters, the microbatch
policy and ``seq_parallel`` as the reference's ``compile_variant`` sets
them); any other ``DxM`` (``1x4``: the EP layout of the card's smoke run)
counts a mesh of virtual ranks, whose step is the whole one. The count is
whole: no 2- and 3-trip extrapolation. Each variant prints one line on
stdout (the reference's), and ``--out`` writes the rows as JSON:

* ``compute`` and ``memory``: the counted FLOPs and bytes (the rank's, or
  the whole step's over virtual ranks) priced on the H100's data-sheet
  rates (``core.hardware.H100``);
* ``collective``: the bytes a rank sends (on a production mesh every
  transfer of rank 0, the backward's included; over virtual ranks
  ``parallel/comm.VirtualComm``'s forward count) at the H100's NVLink
  rate, a prediction for an NVLink box;
* ``args`` and ``temp``: the argument bytes and the peak live bytes of the
  count, in GiB.

:func:`variant_steps` builds the same step on a device, so that a run on
the card measures what was counted. ``--sched-sweep``,
``--selector-report`` and ``--report-out`` hand off to
``launch.schedsweep``, whose makespans are the Ascend A3 model's.

Differences from the reference: an unknown variant name is an argparse
error (the reference skips it); over virtual ranks ``zero1``, ``nosp`` and
``baseline`` place nothing differently, so they count the same work.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from ..configs import get_config
from ..parallel.ep import EPConfig
from . import steps as St
from .dryrun import PRODUCTION, count_cell
from .mesh import counting_mesh, make_mesh, mesh_dims

CELLS = {
    "granite_train": ("granite-moe-3b-a800m", "train_4k"),
    "hubert_train": ("hubert-xlarge", "train_4k"),
    "llama_decode": ("llama3.2-3b", "decode_32k"),
}

# name -> (printed tag, ModelConfig fields, compile_variant's keywords), as
# the reference's if-chain passes them; "opt" resolves by arch
# (:func:`resolve_variant`).
VARIANTS = {
    "baseline": ("baseline(tp_sp)", {}, {"mode": "tp_sp"}),
    "zero1": ("zero1", {}, {"mode": "zero1"}),
    "zero1_noremat": ("zero1_noremat", {"remat": False}, {"mode": "zero1"}),
    "ep_dp": ("ep_dp", {}, {"mode": "ep_dp"}),
    "ep_dp_savemoe": ("ep_dp_savemoe", {"remat_policy": "save_moe"},
                      {"mode": "ep_dp"}),
    "ep_dp_baselinea2a": ("ep_dp+a2a", {},
                          {"ep_mode": "baseline", "mode": "ep_dp"}),
    "flashdecode_off": ("decode_dense_gspmd", {}, {"flash_decode": False}),
    "nosp": ("tp_nosp", {}, {"seq_parallel": False}),
    "opt": (None, {}, None),
}

COLLECTIVE_NOTE = ("bytes a rank sends at the H100's NVLink rate: "
                   "a prediction for an NVLink box")


def resolve_variant(arch: str, variant: str) -> tuple:
    """(tag, config fields, compile keywords) of ``variant`` for ``arch``:
    ``opt`` is ``ep_dp`` for the MoE archs, else ``zero1``."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: one of "
                         f"{', '.join(VARIANTS)}")
    if variant == "opt":
        mode = "ep_dp" if "moe" in arch or "granite" in arch else "zero1"
        return f"opt({mode})", {}, {"mode": mode}
    return VARIANTS[variant]


def step_kwargs(cfg, *, mode: str = "tp_sp",
                ep_mode: str = "hyperparallel", cap_factor: float = 1.25,
                seq_parallel: bool = True, flash_decode: bool = True,
                process: bool = False) -> dict:
    """``make_steps``' keywords for the reference's ``compile_variant``
    arguments: EP on for the MoE family; the microbatches are
    ``make_steps``' own policy, the reference's (8, 4 or 1 by parameter
    count). On a process mesh (``process``) ``seq_parallel`` and FSDP
    (above 10e9 parameters) are passed; over virtual ranks they place
    nothing and are dropped."""
    ep = (EPConfig(mode=ep_mode, capacity_factor=cap_factor)
          if cfg.family == "moe" else None)
    kw = {"ep": ep, "mode": mode, "flash_decode": flash_decode}
    if process:
        kw.update(seq_parallel=seq_parallel,
                  fsdp=cfg.param_count() > 10e9)
    return kw


def variant_config(cfg, variant: str, process: bool = False, **kw) -> tuple:
    """(tag, the variant's config, ``make_steps``' keywords); ``kw``
    override the variant's compile keywords; ``process``: for a process
    mesh."""
    tag, fields, compile_kw = resolve_variant(cfg.name, variant)
    cfg = dataclasses.replace(cfg, **fields) if fields else cfg
    return tag, cfg, step_kwargs(cfg, **{**compile_kw, **kw},
                                 process=process)


def variant_steps(cfg, mesh, variant: str, **kw) -> tuple:
    """(the variant's config, its ``StepFns`` over ``mesh``): the step that
    :func:`count_variant` counts, on ``mesh``'s device."""
    _, vcfg, step_kw = variant_config(cfg, variant, **kw)
    return vcfg, St.make_steps(vcfg, mesh, **step_kw)


def count_variant(cfg, shape, mesh, variant: str = "baseline", **kw):
    """The variant's real step counted on the meta device over ``mesh``
    (virtual ranks on meta, or a counting process mesh): (tag,
    ``Roofline``, seconds)."""
    tag, vcfg, step_kw = variant_config(cfg, variant,
                                        process=bool(mesh.local_rows), **kw)
    rf, dt = count_cell(vcfg, shape, mesh, **step_kw)
    return tag, rf, dt


def count_mesh(dims):
    """The mesh a variant is counted on: a production mesh's counting
    mesh (rank 0), or virtual ranks on meta."""
    if "x".join(map(str, dims)) in PRODUCTION:
        return counting_mesh(dims)
    return make_mesh(dims, "meta")


def line(tag: str, rf) -> str:
    """The reference's line of one variant."""
    return (f"[{tag}] compute={rf.t_compute * 1e3:8.1f}ms "
            f"memory={rf.t_memory * 1e3:8.1f}ms "
            f"collective={rf.t_collective * 1e3:8.1f}ms "
            f"→ {rf.bottleneck}-bound frac={rf.roofline_frac:.3f} "
            f"(args={rf.arg_bytes / 2**30:.1f}G "
            f"temp={rf.temp_bytes / 2**30:.1f}G)")


def variant_row(cfg, shape, variant: str, dims=(1, 4), **kw) -> dict:
    """Count one variant on ``count_mesh(dims)``: its ``Roofline.row()``
    plus ``tag``, ``args_gb``, ``temp_gb``, its line and the count's
    seconds."""
    tag, rf, dt = count_variant(cfg, shape, count_mesh(dims), variant, **kw)
    return {**rf.row(), "tag": tag, "variant": variant,
            "args_gb": rf.arg_bytes / 2**30,
            "temp_gb": rf.temp_bytes / 2**30,
            "collective_bytes_per_rank": rf.collective_bytes,
            "collective_note": COLLECTIVE_NOTE, "line": line(tag, rf),
            "count_s": dt}


def count_job(cfg, shape, variant: str, dims=(1, 4)):
    """One variant's count for ``dryrun.count_all(..., fn=count_job)``:
    (its row, None), or (None, its failure)."""
    try:
        return variant_row(cfg, shape, variant, dims), None
    except Exception as e:  # noqa: BLE001 -- reported, the run goes on
        name = shape if isinstance(shape, str) else shape.name
        return None, (cfg.name, name, variant, repr(e))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", choices=list(CELLS))
    ap.add_argument("--variants", default="baseline,opt")
    ap.add_argument("--mesh", default="16x16", metavar="DxM",
                    help="16x16 or 2x16x16: rank 0 of the production "
                         "mesh's counting mesh; any other DxM: virtual "
                         "ranks (1x1, 1x4, 1x16)")
    ap.add_argument("--sched-sweep", action="store_true",
                    help="sweep SCHED_PIPELINES (+ the auto selector) "
                         "through the simulator instead of counting a "
                         "cell")
    ap.add_argument("--selector-report", action="store_true",
                    help="with --sched-sweep: dump the selector accuracy "
                         "table (predicted vs simulated makespan for every "
                         "priced candidate) instead of the pipeline table")
    ap.add_argument("--ep", type=int, default=8)
    ap.add_argument("--out", default=None)
    ap.add_argument("--report-out", default=None, metavar="PATH",
                    help="with --selector-report: write predicted-vs-"
                         "simulated rows as JSONL (selector-calibration "
                         "dataset)")
    args = ap.parse_args(argv)
    if args.sched_sweep or args.selector_report or args.report_out:
        # One sweep CLI surface: flags and cross-flag checks are the
        # sweep's own.
        from .schedsweep import main as sweep_main
        sweep_argv = ["--ep", str(args.ep)]
        sweep_argv += (["--selector-report"] if args.selector_report
                       else (["--sched-sweep"] if args.sched_sweep else []))
        if args.out:
            sweep_argv += ["--out", args.out]
        if args.report_out:
            sweep_argv += ["--report-out", args.report_out]
        sweep_main(sweep_argv)
        return []
    if args.cell is None:
        ap.error("--cell is required unless --sched-sweep is given")
    variants = args.variants.split(",")
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        ap.error(f"unknown variant(s) {unknown}; choices: "
                 f"{', '.join(VARIANTS)}")
    try:
        dims = mesh_dims(args.mesh)
    except ValueError as e:
        ap.error(str(e))
    arch, shape = CELLS[args.cell]
    cfg = get_config(arch)
    print(f"# {arch} x {shape} on mesh {args.mesh}, counted on the meta "
          f"device; collective = {COLLECTIVE_NOTE}", file=sys.stderr)
    rows = []
    for v in variants:
        rows.append(variant_row(cfg, shape, v, dims))
        print(rows[-1]["line"], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1, default=str)
    return rows


if __name__ == "__main__":
    main()
