"""Benchmark runner, one section per paper table or figure — counterpart of
``benchmarks/run.py``.

    PYTHONPATH=src python -m repro_torch.launch.bench_run [--only moe_ffn,step,...]
    PYTHONPATH=src python -m repro_torch.launch.bench_run --device cpu --smoke

Prints CSV rows ``name,us_per_call,derived`` under one header. A section
that raises prints ``<key>_FAILED,0,<error>`` and the run goes on; the exit
code is then 1.

Three sections run on the card (``--device``, default ``cuda``; without a
card they fail unless ``--device cpu``): ``swiglu_add``, ``dropless`` (the
reference's bucket-policy rows on the host, then the port's fragment
benchmark on the card) and ``ep_modes``. ``--smoke`` runs them at their
CPU-sized shapes. The simulator's sections (``moe_ffn``, ``step``,
``sched_overhead``, ``imbalance``, ``fusion``, ``topology``, parts of
``swiglu_add``) print the Ascend A3 model's predictions, not times of the
H100; ``autoselect``, ``elastic`` and the bucket-policy rows time host
code; ``roofline`` reads the dry run's JSON (``--dryrun-json``): counts
priced on the H100's data-sheet rates.
"""

from __future__ import annotations

import argparse
import importlib
import sys
import traceback

from .bench_common import CSV_HEADER

SECTIONS = [
    ("moe_ffn", "Table 3 / Fig 7: Dispatch-to-Combine latency",
     "bench_moe_ffn"),
    ("step", "Fig 8: end-to-end training step", "bench_step"),
    ("swiglu_add", "Fig 9: SwiGLU+Add tile interleaving / L2 reuse",
     "bench_swiglu_add"),
    ("sched_overhead", "Fig 10: static vs dynamic scheduling",
     "bench_sched_overhead"),
    ("autoselect", "Cost-model-guided pipeline selection latency",
     "bench_autoselect"),
    ("imbalance", "Routing-skew sweep: unified vs baseline under load skew",
     "bench_imbalance"),
    ("dropless", "Dropless plan-keyed schedule reuse per bucket policy",
     "bench_dropless_buckets"),
    ("replay", "Decode-trace replay: bucket policies under serving traffic",
     "bench_replay"),
    ("fusion", "Cross-layer fusion: fused vs back-to-back fragment makespan",
     "bench_fusion"),
    ("topology", "Topology-aware hierarchical EP: two-level vs flat dispatch",
     "bench_topology"),
    ("elastic", "Elastic rescale path: remap / re-key / biased selection",
     "bench_elastic"),
    ("ep_modes", "EP mode comparison on the port's virtual ranks",
     "bench_ep_modes"),
    ("roofline", "H100 roofline table from the dry run", "bench_roofline"),
]


def _card_argv(key: str, args) -> list:
    """The card sections' arguments: the runner's device, and their
    CPU-sized shapes under ``--smoke``."""
    argv = ["--device", args.device]
    if key == "swiglu_add":
        return argv + (["--sizes", "256"] if args.smoke else [])
    if key == "dropless":
        return argv + (["--smoke", "--tokens", "64"] if args.smoke else [])
    return argv + ([] if args.smoke else ["--full"])      # ep_modes


def _module(name: str):
    return importlib.import_module(f".{name}", __package__)


def run_section(key: str, module: str, args) -> None:
    mod = _module(module)
    if key == "dropless":
        # The reference's bucket-policy rows, then the fragment on the card.
        mod.run()
        _module("bench_dropless").main(_card_argv(key, args))
    elif key in ("swiglu_add", "ep_modes"):
        mod.main(_card_argv(key, args))
    elif key == "roofline":
        mod.run(args.dryrun_json)
    else:
        mod.run()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=None, metavar="NAME[,NAME...]",
                    help="comma-separated section names to run "
                         f"(choices: {','.join(k for k, *_ in SECTIONS)})")
    ap.add_argument("--device", default="cuda",
                    help="the card sections' device")
    ap.add_argument("--smoke", action="store_true",
                    help="the card sections at their CPU-sized shapes")
    ap.add_argument("--dryrun-json", default="dryrun.json",
                    help="the dry run's --out, for the roofline section")
    args = ap.parse_args(argv)
    only = None
    if args.only:
        only = {name.strip() for name in args.only.split(",") if name.strip()}
        known = {k for k, *_ in SECTIONS}
        unknown = only - known
        if unknown:
            ap.error(f"unknown section(s) {sorted(unknown)}; "
                     f"choices: {sorted(known)}")

    print(CSV_HEADER, flush=True)
    failed = []
    for key, title, module in SECTIONS:
        if only and key not in only:
            continue
        print(f"# --- {title} ---", flush=True)
        try:
            run_section(key, module, args)
        except Exception as e:  # noqa: BLE001 -- reported, the run goes on
            failed.append((key, e))
            traceback.print_exc(limit=4)
            print(f"{key}_FAILED,0,{e}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
