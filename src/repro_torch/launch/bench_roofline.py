"""Roofline table — counterpart of ``benchmarks/bench_roofline.py``.

Reads the dry run's JSON (``python -m repro_torch.launch.dryrun --all --out
dryrun.json``) and prints one row a cell: the larger of its compute and
memory terms in µs, and what bounds it. Every number is a count of the
step's work on the meta device priced on the H100's data-sheet rates
(``core.hardware.H100``), a bound, not a time of any device.

    PYTHONPATH=src python -m repro_torch.launch.bench_roofline [dryrun.json]

Rows are CSV ``name,us_per_call,derived``.
"""

from __future__ import annotations

import json
import os
import sys

from .bench_common import emit

DRYRUN_JSON = "dryrun.json"


def run(path: str = DRYRUN_JSON) -> None:
    if not os.path.exists(path):
        emit("roofline_table", 0.0,
             f"{path} missing — run: python -m repro_torch.launch.dryrun "
             f"--all --out {path}")
        return
    with open(path) as f:
        data = json.load(f)
    for row in data["rows"]:
        t_dom = max(row["t_compute_s"], row["t_memory_s"],
                    row["t_collective_s"])
        emit(f"roofline_{row['arch']}_{row['shape']}_{row['mesh']}",
             t_dom * 1e6,
             f"bound={row['bottleneck']} frac={row['roofline_frac']:.3f} "
             f"compute={row['t_compute_s'] * 1e3:.1f}ms "
             f"mem={row['t_memory_s'] * 1e3:.1f}ms "
             f"coll={row['t_collective_s'] * 1e3:.1f}ms")
    if data.get("failures"):
        emit("roofline_failures", float(len(data["failures"])),
             ";".join("|".join(x[:3]) for x in data["failures"]))


if __name__ == "__main__":
    run(*sys.argv[1:2])
