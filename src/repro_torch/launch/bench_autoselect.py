"""Selector overhead — auto-selection must not eat the compile win —
counterpart of ``benchmarks/bench_autoselect.py``.

    PYTHONPATH=src python -m repro_torch.launch.bench_autoselect

Cost-model-guided pipeline selection (``core/autoselect.py``) runs on the
compile path of every new plan the dropless trainer sees, so its latency
has to stay orders of magnitude under schedule compilation and its
memoized hit has to be effectively free (bucketed batch plans repeat).

Gates: a hard per-plan budget on the cold selection (COLD_BUDGET_MS) and
on the memoized path (WARM_BUDGET_MS); a failed gate raises
``AssertionError``. One row per routing profile with the resolved pick, so
a selector that silently resolves everything to ``naive`` shows. The µs of
a row are the host's time to select (this machine's CPU, not a device);
``predicted`` is the Ascend A3 cost model's prediction, not a time of the
H100 or of any device.
"""

from __future__ import annotations

import time

import numpy as np

from ..core.autoselect import (select, selection_cache_clear,
                               selection_cache_info)
from ..core.odg import ScheduleConfig
from ..core.routing import hotspot_plan, random_plan, skewed_plan
from .bench_common import emit

EP, E_LOC, ROWS = 8, 8, 128
D_MODEL, D_FF = 2048, 512
M_SPLIT = 64
COLD_BUDGET_MS = 100.0      # per (plan, direction); compile is ~10x this
WARM_BUDGET_MS = 1.0        # memoized per-batch path


def _profiles():
    rng = np.random.default_rng(0)
    yield "balanced", None
    yield "zipf1", skewed_plan(EP, E_LOC, ROWS, 1.0)
    yield "zipf2", skewed_plan(EP, E_LOC, ROWS, 2.0)
    yield "hotspot", hotspot_plan(EP, E_LOC, ROWS)
    yield "hotspot_bg", hotspot_plan(EP, E_LOC, ROWS, background=16)
    yield "sparse", random_plan(EP, E_LOC, ROWS // 4, rng, p_zero=0.5)


def run() -> list[tuple]:
    """Every row ``(name, us, derived)``, each also emitted; raises
    ``AssertionError`` when a budget is blown."""
    rows = []
    worst_cold = worst_warm = 0.0
    for name, plan in _profiles():
        cfg = ScheduleConfig(ep=EP, e_loc=E_LOC, rows=ROWS, d_model=D_MODEL,
                             d_ff=D_FF, gmm_m_split=M_SPLIT,
                             gmm_split_mode="source_aligned", plan=plan)
        for direction in ("forward", "backward"):
            selection_cache_clear()
            t0 = time.perf_counter()
            choice = select(cfg.routing, cfg, direction=direction)
            cold_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            select(cfg.routing, cfg, direction=direction)
            warm_ms = (time.perf_counter() - t0) * 1e3
            worst_cold = max(worst_cold, cold_ms)
            worst_warm = max(worst_warm, warm_ms)
            rows.append((f"autoselect_{name}_{direction[:3]}", cold_ms * 1e3,
                         f"warm={warm_ms * 1e3:.1f}us pick={choice.tag} "
                         f"candidates={len(choice.scores)} "
                         f"predicted={choice.predicted_us:.1f}us"))
            emit(*rows[-1])
    info = selection_cache_info()
    if not worst_cold < COLD_BUDGET_MS:
        raise AssertionError(
            f"cold selection {worst_cold:.1f}ms blows the {COLD_BUDGET_MS}ms "
            f"budget — selection is eating the compile-time win")
    if not worst_warm < WARM_BUDGET_MS:
        raise AssertionError(
            f"memoized selection {worst_warm:.2f}ms — the per-batch dropless "
            f"path would feel this")
    rows.append(("autoselect_worst_cold", worst_cold * 1e3,
                 f"budget={COLD_BUDGET_MS}ms warm_worst={worst_warm:.3f}ms "
                 f"cache={info.hits}h/{info.misses}m"))
    emit(*rows[-1])
    return rows


if __name__ == "__main__":
    run()
