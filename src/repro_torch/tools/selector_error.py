"""Aggregate selector-report JSONL into tracked accuracy metrics —
counterpart of ``tools/selector_error.py``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.schedsweep \
        --selector-report --ep 4 --report-out selector_report.jsonl
    PYTHONPATH=src python -m repro_torch.tools.selector_error \
        selector_report.jsonl \
        [--min-argmin-rate 0.5] [--max-mean-regret 0.10] [--json out.json]

Each input line is one (scenario, direction, candidate) row from
``repro_torch.launch.schedsweep.selector_report``: its predictions and
simulated makespans are the Ascend A3 model's, not times of any device.
Absolute predictions are structural lower bounds, so the tracked metrics
are *ordering* metrics:

* ``argmin_match_rate`` — fraction of scenarios where the selector's pick
  is the simulated optimum over the priced candidates;
* ``mean_regret`` / ``max_regret`` — simulated cost of the pick relative
  to the simulated optimum (0.0 when the pick is the optimum);
* ``pairwise_ordering_accuracy`` — fraction of within-scenario candidate
  pairs whose predicted ordering matches the simulated ordering (ties in
  either ordering are skipped);
* ``underprediction_ratio`` (context) — median simulated/predicted ratio,
  the calibration headroom a selector calibration would fit.

Gates are off unless requested; CI passes thresholds so a selector
regression fails the build instead of silently drifting.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path


def load_rows(paths: list[str]) -> list[dict]:
    rows = []
    for name in paths:
        p = Path(name)
        if not p.exists():
            raise FileNotFoundError(f"{name}: no such report")
        for n, line in enumerate(p.read_text().splitlines(), 1):
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{name}:{n}: bad JSONL row: {e}") from None
    return rows


def aggregate(rows: list[dict]) -> dict:
    """Selector accuracy metrics over one or more JSONL reports."""
    scenarios: dict[tuple, list[dict]] = {}
    for r in rows:
        scenarios.setdefault((r["plan"], r["direction"], r["ep"],
                              r["rows"], r["d_model"], r["d_ff"]),
                             []).append(r)
    matches, regrets, ratios = [], [], []
    pair_ok = pair_all = 0
    for cands in scenarios.values():
        picked = [c for c in cands if c["picked"]]
        if picked:
            matches.append(any(c["sim_best"] for c in picked))
            regrets.extend(c["regret"] for c in picked
                           if c.get("regret") is not None)
        ratios.extend(c["simulated_us"] / c["predicted_us"]
                      for c in cands if c["predicted_us"] > 0)
        for i, a in enumerate(cands):
            for b in cands[i + 1:]:
                dp = a["predicted_us"] - b["predicted_us"]
                ds = a["simulated_us"] - b["simulated_us"]
                if dp == 0 or ds == 0:
                    continue
                pair_all += 1
                pair_ok += (dp > 0) == (ds > 0)
    return {
        "rows": len(rows),
        "scenarios": len(scenarios),
        "argmin_match_rate": (sum(matches) / len(matches)
                              if matches else None),
        "mean_regret": statistics.mean(regrets) if regrets else None,
        "max_regret": max(regrets) if regrets else None,
        "pairwise_ordering_accuracy": (pair_ok / pair_all
                                       if pair_all else None),
        "underprediction_ratio_median": (statistics.median(ratios)
                                         if ratios else None),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="selector-report JSONL -> tracked accuracy metrics")
    ap.add_argument("reports", nargs="+", metavar="REPORT.jsonl")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also dump the metrics dict as JSON")
    ap.add_argument("--min-argmin-rate", type=float, default=None,
                    help="fail if argmin_match_rate drops below this")
    ap.add_argument("--max-mean-regret", type=float, default=None,
                    help="fail if mean_regret exceeds this")
    args = ap.parse_args(argv)

    metrics = aggregate(load_rows(args.reports))
    for k, v in metrics.items():
        print(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(metrics, f, indent=1)

    failures = []
    if (args.min_argmin_rate is not None
            and (metrics["argmin_match_rate"] or 0.0) < args.min_argmin_rate):
        failures.append(f"argmin_match_rate {metrics['argmin_match_rate']} "
                        f"< {args.min_argmin_rate}")
    if (args.max_mean_regret is not None
            and (metrics["mean_regret"] or 0.0) > args.max_mean_regret):
        failures.append(f"mean_regret {metrics['mean_regret']} "
                        f"> {args.max_mean_regret}")
    for msg in failures:
        print(f"selector accuracy gate failed: {msg}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
