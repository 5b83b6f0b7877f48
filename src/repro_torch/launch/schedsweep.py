"""Schedule-pipeline sweep + selector accuracy report on the port's
``core/`` — counterpart of ``repro.launch.schedsweep`` (its rows equal the
reference's). Host-only: the simulator prices an Ascend A3 model, so every
makespan here is a prediction for that hardware, not a measurement.

    PYTHONPATH=src python -m repro_torch.launch.schedsweep --sched-sweep
    PYTHONPATH=src python -m repro_torch.launch.schedsweep --selector-report

Two entry points:

* :func:`sched_sweep` — every ``SCHED_PIPELINES`` entry (``core/passes.py``)
  plus an ``auto`` row (the cost-model-guided selector,
  ``core/autoselect.py``) × routing scenarios × directions, through the
  discrete-event simulator. The ``auto`` row records what the selector
  resolved to (``resolved``/``resolved_m_split``) and its compile-time
  prediction (``predicted_us``) next to the simulated makespan.
* :func:`selector_report` — per scenario, every candidate the selector
  priced, simulated: predicted vs simulated makespan and whether the
  selector's argmin matched the simulator's.
"""

from __future__ import annotations

import json

from ..core.autoselect import select
from ..core.odg import (ScheduleConfig, build_moe_ffn_backward,
                        build_moe_ffn_forward)
from ..core.passes import SCHED_PIPELINES
from ..core.routing import hotspot_plan, skewed_plan
from ..core.scheduler import compile_schedule
from ..core.simulator import simulate_unified

_BUILDERS = {"forward": build_moe_ffn_forward,
             "backward": build_moe_ffn_backward}


def sweep_scenarios(ep: int, e_loc: int, rows: int):
    """The routing-scenario matrix: (name, plan-or-None) pairs."""
    # Background traffic must fit each source's token budget at any --ep.
    bg = max(0, min(16, ep * e_loc * rows // (ep * e_loc - 1) - (ep - 1)))
    return [
        ("balanced", None),
        ("skewed", skewed_plan(ep, e_loc, rows, 1.0)),
        ("hotspot", hotspot_plan(ep, e_loc, rows)),
        ("hotspot_bg", hotspot_plan(ep, e_loc, rows, background=bg)),
    ]


def _scenario_cfg(plan, ep: int, e_loc: int, rows: int, d_model: int,
                  d_ff: int, gmm_m_split: int) -> ScheduleConfig:
    return ScheduleConfig(ep=ep, e_loc=e_loc, rows=rows, d_model=d_model,
                          d_ff=d_ff, gmm_m_split=gmm_m_split,
                          gmm_split_mode="source_aligned", plan=plan)


def sched_sweep(ep: int = 8, out: str | None = None, *, e_loc: int = 8,
                rows: int = 128, d_model: int = 2048, d_ff: int = 512,
                gmm_m_split: int | None = None, include_auto: bool = True,
                quiet: bool = False) -> list[dict]:
    """Hillclimb over schedule pass pipelines on skewed routing scenarios.

    Sizing keywords exist so the tier-1 regression gate can run a
    fixture-sized sweep in seconds; the CLI default reproduces the full
    ep=8 table. Returns one row dict per (scenario, direction, pipeline),
    with an extra ``auto`` row per (scenario, direction) when
    ``include_auto`` — ``vs_naive`` > 1 means faster than naive.
    """
    m_split = gmm_m_split if gmm_m_split is not None else 8 * ep
    rows_out: list[dict] = []
    for plan_name, plan in sweep_scenarios(ep, e_loc, rows):
        cfg = _scenario_cfg(plan, ep, e_loc, rows, d_model, d_ff, m_split)
        for direction, builder in _BUILDERS.items():
            base_us = None
            fixed_res: dict[str, object] = {}
            entries = list(SCHED_PIPELINES.items())
            if include_auto:
                entries.append(("auto", "auto"))
            for tag, pipeline in entries:
                row = {"plan": plan_name, "direction": direction,
                       "pipeline": tag}
                if tag == "auto":
                    choice = select(cfg.routing, cfg, direction=direction)
                    row.update(resolved=choice.tag,
                               resolved_spec=choice.pipeline.spec(),
                               resolved_m_split=choice.cfg.gmm_m_split,
                               predicted_us=choice.predicted_us)
                    if choice.cfg == cfg and choice.tag in fixed_res:
                        # Un-retiled resolution to a fixed entry: the
                        # schedule is byte-identical to one already
                        # measured — skip the duplicate ~1s compile+sim.
                        res = fixed_res[choice.tag]
                    else:
                        res = simulate_unified(compile_schedule(
                            _BUILDERS[direction](choice.cfg),
                            pipeline=choice.pipeline))
                else:
                    res = simulate_unified(
                        compile_schedule(builder(cfg), pipeline=pipeline))
                    fixed_res[tag] = res
                if base_us is None:
                    base_us = res.makespan_us
                row.update(makespan_us=res.makespan_us,
                           vs_naive=base_us / res.makespan_us,
                           straggler=res.straggler_ratio,
                           mac_ratio=res.mac_ratio)
                rows_out.append(row)
                if not quiet:
                    extra = (f" ← {row['resolved']}" if tag == "auto" else "")
                    print(f"[sched {plan_name}/{direction}] {tag:12s} "
                          f"makespan={res.makespan_us:9.1f}us "
                          f"x{row['vs_naive']:.3f} vs naive "
                          f"straggler={res.straggler_ratio:.2f} "
                          f"mac={res.mac_ratio:.3f}{extra}")
    if out:
        with open(out, "w") as f:
            json.dump(rows_out, f, indent=1)
    return rows_out


def selector_report(ep: int = 8, out: str | None = None, *, e_loc: int = 8,
                    rows: int = 128, d_model: int = 2048, d_ff: int = 512,
                    gmm_m_split: int | None = None,
                    report_out: str | None = None,
                    quiet: bool = False) -> list[dict]:
    """Predicted-vs-simulated makespan for every candidate the selector
    priced — the selector's accuracy table.

    Absolute predictions are structural lower bounds (queue/startup
    chaining is not modeled), so the interesting columns are the per-
    scenario *ordering*: ``picked`` flags the selector's argmin,
    ``sim_best`` the simulator's, and ``regret`` what the pick costs
    relative to the simulated optimum over the priced candidates.

    ``report_out`` appends-nothing/overwrites a JSONL file — one
    predicted-vs-simulated row per line, each stamped with the sweep's
    sizing — the accumulating dataset the ROADMAP "selector calibration"
    item fits the pass-effect constants from (``out`` remains the
    one-shot JSON dump).
    """
    m_split = gmm_m_split if gmm_m_split is not None else 8 * ep
    sizing = {"ep": ep, "e_loc": e_loc, "rows": rows, "d_model": d_model,
              "d_ff": d_ff, "gmm_m_split": m_split}
    rows_out: list[dict] = []
    for plan_name, plan in sweep_scenarios(ep, e_loc, rows):
        cfg = _scenario_cfg(plan, ep, e_loc, rows, d_model, d_ff, m_split)
        for direction in _BUILDERS:
            choice = select(cfg.routing, cfg, direction=direction)
            sims = {}
            for cand in choice.scores:
                sched = compile_schedule(_BUILDERS[direction](cand.cfg),
                                         pipeline=cand.pipeline)
                sims[cand.tag] = simulate_unified(sched).makespan_us
            sim_best = min(sims, key=sims.get)
            for cand in choice.scores:
                picked = cand.tag == choice.tag
                rows_out.append({
                    "plan": plan_name, "direction": direction,
                    "candidate": cand.tag,
                    "pipeline": cand.pipeline.spec(),
                    "cand_m_split": cand.cfg.gmm_m_split,
                    "predicted_us": cand.predicted_us,
                    "simulated_us": sims[cand.tag],
                    "picked": picked,
                    "sim_best": cand.tag == sim_best,
                    "regret": (sims[choice.tag] / sims[sim_best] - 1.0
                               if picked else None),
                    **sizing,
                })
                if not quiet:
                    mark = ("←pick" if picked else "") + \
                           ("*best" if cand.tag == sim_best else "")
                    print(f"[selector {plan_name}/{direction}] "
                          f"{cand.tag:16s} predicted={cand.predicted_us:8.1f}"
                          f"us simulated={sims[cand.tag]:8.1f}us {mark}")
            if not quiet:
                regret = sims[choice.tag] / sims[sim_best] - 1.0
                print(f"[selector {plan_name}/{direction}] regret of pick: "
                      f"{regret:+.2%}")
    if out:
        with open(out, "w") as f:
            json.dump(rows_out, f, indent=1)
    if report_out:
        with open(report_out, "w") as f:
            for row in rows_out:
                f.write(json.dumps(row) + "\n")
    return rows_out


def main(argv=None):
    """The sweep's command line."""
    import argparse
    ap = argparse.ArgumentParser(
        description="schedule-pipeline sweep / selector accuracy report "
                    "(simulated Ascend A3 makespans)")
    ap.add_argument("--sched-sweep", action="store_true",
                    help="run the SCHED_PIPELINES (+auto) sweep table")
    ap.add_argument("--selector-report", action="store_true",
                    help="dump predicted-vs-simulated makespan for every "
                         "candidate the selector priced")
    ap.add_argument("--ep", type=int, default=8)
    ap.add_argument("--out", default=None,
                    help="write the table as one JSON document")
    ap.add_argument("--report-out", default=None, metavar="PATH",
                    help="with --selector-report: write one predicted-vs-"
                         "simulated row per line as JSONL (the selector-"
                         "calibration dataset)")
    args = ap.parse_args(argv)
    if args.report_out and not args.selector_report:
        ap.error("--report-out requires --selector-report")
    if args.selector_report:
        selector_report(ep=args.ep, out=args.out,
                        report_out=args.report_out)
    elif args.sched_sweep:
        sched_sweep(ep=args.ep, out=args.out)
    else:
        ap.error("nothing to do: pass --sched-sweep or --selector-report")


if __name__ == "__main__":
    main()
