"""Dropless schedule reuse — recompile rate and padded rows per bucket
policy — counterpart of ``benchmarks/bench_dropless.py`` (the port's
``bench_dropless`` is the card's fragment benchmark).

    PYTHONPATH=src python -m repro_torch.launch.bench_dropless_buckets

Host only. STEPS churned decode-shaped batches from three traffic profiles
(uniform, Zipf, hotspot; the hotspot sized so that its hot cell straddles
``linear:16``'s 64-row boundary) replayed through each policy's cache path,
forward and backward schedules: ``exact`` keys, ``linear:16``,
``geometric:8`` and a ladder fitted on a held-out trace
(``core.buckets.fit_ladder``). Each row's ``us_per_call`` is this host's
wall clock per plan build and both fetch-or-compiles (not a device time),
with the recompile and hit rates and the padded-row ratio.

Gates (``AssertionError``): on every profile bucketing beats exact keys'
hit rate, and the fitted ladder matches or beats ``linear:16``'s hit rate
at a strictly lower padded-row ratio.
"""

from __future__ import annotations

from ..core.buckets import BucketSpec, fit_ladder
from ..models.moe import MoEConfig
from .bench_common import emit
from .replay import exact_plans, replay_trace, synth_trace

EP, E_LOC, T_LOC, TOP_K = 4, 2, 72, 2
D_MODEL, D_FF = 64, 32
STEPS = 24
# Slot turnover per step: the fraction of token choices re-routed between
# successive batches (continuous batching keeps the rest decoding).
CHURN = 0.08
PIPELINE = ["ratr", "gmm_interleave"]
PROFILES = ("uniform", "zipf", "hotspot")
# Per-profile fit constants (rung budget, split penalty), the reference's:
# where the fitted ladder dominates linear:16 on this deterministic traffic.
FIT = {"uniform": (3, 1.0), "zipf": (4, 0.25), "hotspot": (3, 0.5)}

MC = MoEConfig(n_experts=EP * E_LOC, top_k=TOP_K, d_expert=D_FF)


def _trace(profile: str, seed: int):
    return synth_trace(profile, STEPS, ep=EP, e_loc=E_LOC, t_loc=T_LOC,
                       top_k=TOP_K, seed=seed, churn=CHURN)


def _policies(profile: str) -> dict:
    budget, lam = FIT[profile]
    fitted = fit_ladder(exact_plans(_trace(profile, seed=1), MC, EP),
                        budget, split_penalty=lam)
    return {"exact": BucketSpec.exact(), "linear16": BucketSpec.linear(16),
            "geometric8": BucketSpec.geometric(8), "fitted": fitted}


def run() -> list[tuple]:
    """Every row ``(name, us, derived)``, each also emitted; raises
    ``AssertionError`` where a gate fails."""
    rows, results = [], {}
    for profile in PROFILES:
        for r in replay_trace(_trace(profile, seed=0), MC, EP,
                              _policies(profile), d_model=D_MODEL, d_ff=D_FF,
                              pipeline=PIPELINE,
                              directions=("forward", "backward"),
                              simulate=False, max_entries=4 * STEPS):
            results[(profile, r["policy"])] = r
            rows.append((f"dropless_{profile}_{r['policy']}",
                         r["fetch_us_mean"],
                         f"recompile_rate={r['recompile_rate']:.2f} "
                         f"hit_rate={r['hit_rate']:.2f} "
                         f"pad_overhead={r['pad_ratio']:.2f}x "
                         f"spec={r['spec']}"))
            emit(*rows[-1])
    for profile in PROFILES:
        exact = results[(profile, "exact")]
        lin = results[(profile, "linear16")]
        fitted = results[(profile, "fitted")]
        best = max(lin["hit_rate"], fitted["hit_rate"],
                   results[(profile, "geometric8")]["hit_rate"])
        if not best > exact["hit_rate"]:
            raise AssertionError(
                f"{profile}: bucketing must raise the cache hit rate "
                f"({best:.2f} vs {exact['hit_rate']:.2f})")
        if not (fitted["hit_rate"] >= lin["hit_rate"]
                and fitted["pad_ratio"] < lin["pad_ratio"]):
            raise AssertionError(
                f"{profile}: fitted ladder must match/beat linear:16's hit "
                f"rate at strictly lower padding (fitted "
                f"hit={fitted['hit_rate']:.2f} pad={fitted['pad_ratio']:.2f}"
                f" vs linear hit={lin['hit_rate']:.2f} "
                f"pad={lin['pad_ratio']:.2f})")
    return rows


if __name__ == "__main__":
    run()
