"""Elastic rescale path latency, remap, re-key and biased selection —
counterpart of ``benchmarks/bench_elastic.py`` on the port's ``core/``.

Host-only: it times host bookkeeping on this machine's CPU, and its
selection prices the Ascend A3 cost model. Its rows equal the reference's
but for the times.

    PYTHONPATH=src python -m repro_torch.launch.bench_elastic

A rank loss puts three operations on the recovery critical path before
the first post-rescale step can compile: ``remap_plan`` (per live plan),
``SSCCache.rekey_for_mesh`` (once, over the resident population), and a
selection under the observed-time-biased cost model. They must stay far
under one schedule compile, so the script holds the remap and the re-key
to the reference's budgets and raises beyond them. Rows are CSV
``name,us_per_call,derived``.
"""

from __future__ import annotations

import time

import numpy as np

from ..core.autoselect import select, selection_cache_clear
from ..core.elastic import check_remap, observed_cost_model, remap_plan
from ..core.odg import ScheduleConfig
from ..core.routing import (balanced_plan, hotspot_plan, random_plan,
                            skewed_plan)
from ..core.ssc import SSCCache
from .bench_common import emit

EP, E_LOC, ROWS = 8, 8, 128
D_MODEL, D_FF = 2048, 512
REMAP_BUDGET_MS = 5.0       # per plan; compile is ~200x this
REKEY_BUDGET_MS = 20.0      # once per rescale, whole resident population


def _population(n: int):
    rng = np.random.default_rng(7)
    plans = []
    for i in range(n):
        kind = i % 3
        if kind == 0:
            plans.append(skewed_plan(EP, E_LOC, ROWS, 1.0 + 0.1 * i))
        elif kind == 1:
            plans.append(hotspot_plan(EP, E_LOC, ROWS, background=i))
        else:
            plans.append(random_plan(EP, E_LOC, ROWS, rng, p_zero=0.3))
    return plans


def run() -> list[tuple]:
    """Every row ``(name, us, derived)``, each also emitted; raises when
    the remap or the re-key exceeds its budget."""
    rows = []

    def out(*row):
        rows.append(row)
        emit(*row)

    plans = _population(24)

    # 64 experts re-chunk onto any power-of-two mesh; losing a node of 4
    # ranks (8 -> 4) is the realistic shrink.
    dead = list(range(EP // 2, EP))
    t0 = time.perf_counter()
    remapped = [remap_plan(p, dead_ranks=dead) for p in plans]
    dt = time.perf_counter() - t0
    per_plan_ms = dt / len(plans) * 1e3
    if per_plan_ms >= REMAP_BUDGET_MS:
        raise RuntimeError(f"remap_plan took {per_plan_ms:.3f} ms a plan, "
                           f"budget {REMAP_BUDGET_MS} ms")
    out("elastic_remap_plan", per_plan_ms * 1e3,
        f"plans={len(plans)} ep={EP}->{EP // 2} budget={REMAP_BUDGET_MS}ms")

    t0 = time.perf_counter()
    ok = all(check_remap(p, q, tuple(range(EP // 2)))["ok"]
             for p, q in zip(plans, remapped))
    dt = time.perf_counter() - t0
    if not ok:
        raise RuntimeError("a remapped plan broke its invariants")
    out("elastic_check_remap", dt / len(plans) * 1e6, f"all_ok={ok}")

    # Re-key a resident cache population (no compiles timed — populate
    # with tiny plans so the rekey cost dominates the scenario).
    cache = SSCCache(max_entries=64)
    for p in _population(12):
        small = remap_plan(p, new_ep=4)
        cfg = ScheduleConfig(ep=4, e_loc=small.e_loc, rows=0, d_model=64,
                             d_ff=32, plan=small, bucket=4)
        cache.get_or_compile(cfg, "forward", pipeline=["ratr"])
    t0 = time.perf_counter()
    res = cache.rekey_for_mesh(2)
    dt_ms = (time.perf_counter() - t0) * 1e3
    if dt_ms >= REKEY_BUDGET_MS:
        raise RuntimeError(f"rekey_for_mesh took {dt_ms:.3f} ms, budget "
                           f"{REKEY_BUDGET_MS} ms")
    out("elastic_rekey_for_mesh", dt_ms * 1e3,
        f"entries={res['entries']} active={res['active']} "
        f"evictions={cache.evictions}")

    # Biased selection: the straggler feedback loop prices every candidate
    # under rank_bias. The plan is balanced, so the only skew is the
    # observed bias and critical_rank_first should fire.
    selection_cache_clear()
    plan = balanced_plan(EP, E_LOC, ROWS)
    cfg = ScheduleConfig(ep=EP, e_loc=E_LOC, rows=ROWS, d_model=D_MODEL,
                         d_ff=D_FF, plan=plan)
    times = [100.0] * EP
    times[3] = 300.0
    cm = observed_cost_model(times)
    t0 = time.perf_counter()
    choice = select(plan, cfg, cm)
    dt_ms = (time.perf_counter() - t0) * 1e3
    names = [n for n, _ in choice.pipeline.key()]
    out("elastic_biased_select", dt_ms * 1e3,
        f"pick={choice.tag} crit_pass={'critical_rank_first' in names}")
    return rows


if __name__ == "__main__":
    run()
