"""Schedule explorer: inspect what the static scheduler builds —
counterpart of ``examples/schedule_explorer.py``.

Compiles the paper's module at ``--ep`` ranks, prints each schedule's
rank-0 queue heads, the event table and the simulated makespans (the
Ascend A3 model's predictions, not times of any device), and dumps rank
0's forward SSC view as JSON to ``--dump`` (default: a new file from
``tempfile``), the artifact a device runtime would consume (§5.1). The
schedules are host work: ``--device`` is checked, not used.

Run:  PYTHONPATH=src python -m repro_torch.examples.schedule_explorer [--ep 8]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import tempfile

from ..core.scheduler import compile_schedule
from ..core.simulator import simulate_baseline, simulate_unified
from ..core.ssc import rank_view, schedule_to_ssc
from ..device import resolve_device
from ..launch.bench_common import ffn_graph, opt_pipeline, paper_module_config


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ep", type=int, default=8)
    ap.add_argument("--dump", default=None,
                    help="rank 0's forward SSC view (default: a new "
                         "temporary file)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    cfg = paper_module_config(args.ep, m_split_mult=4)
    out = {"ep": args.ep, "schedules": {}}
    scheds = {}
    for name in ("forward", "backward"):
        s = scheds[name] = compile_schedule(ffn_graph(name)(cfg),
                                            pipeline=opt_pipeline(name))
        ctq, vtq = s.queue(0, "CTQ"), s.queue(0, "VTQ")
        thr = dict(sorted(collections.Counter(
            e.threshold for e in s.events.values()).items()))
        blob = schedule_to_ssc(s)
        b = simulate_baseline(compile_schedule(ffn_graph(name)(
            paper_module_config(args.ep, m_split_mult=1))))
        u = simulate_unified(s)
        out["schedules"][name] = {
            "tasks": s.n_tasks, "events": len(s.events), "ctq0": len(ctq),
            "vtq0": len(vtq), "thresholds": thr, "ssc_bytes": len(blob),
            "base_us": b.makespan_us, "unified_us": u.makespan_us,
            "base_mac": b.mac_ratio, "unified_mac": u.mac_ratio}
        print(f"\n=== {name}: {s.n_tasks} tasks, {len(s.events)} events ===")
        print(f"rank0 CTQ[{len(ctq)}] head: "
              + " ".join(s.tasks[t].op_name.split('@')[0] for t in ctq[:6]))
        print(f"rank0 VTQ[{len(vtq)}] head: "
              + " ".join(f"{s.tasks[t].op_name.split('@')[0]}"
                         f"→{s.tasks[t].dst_rank}" for t in vtq[:6]))
        print(f"event thresholds: {thr}")
        print(f"SSC size: {len(blob) / 1024:.1f} KiB "
              f"({len(blob) // max(1, s.n_tasks)} B/task)")
        print(f"simulated D2C (Ascend A3 model): baseline "
              f"{b.makespan_us / 1e3:.2f}ms → unified "
              f"{u.makespan_us / 1e3:.2f}ms "
              f"({b.makespan_us / u.makespan_us:.2f}x)  "
              f"MAC {b.mac_ratio:.2f}→{u.mac_ratio:.2f}")

    dump = args.dump
    if dump is None:
        fd, dump = tempfile.mkstemp(prefix="ssc_rank0_", suffix=".json")
        os.close(fd)
    out["rank_view"] = rank_view(scheds["forward"], 0)
    with open(dump, "w") as f:
        json.dump(out["rank_view"], f, indent=1)
    out["dump"] = dump
    print(f"\nper-rank SSC (rank 0, forward) dumped to {dump}")
    return out


if __name__ == "__main__":
    main()
