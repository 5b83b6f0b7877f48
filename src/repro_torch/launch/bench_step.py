"""Figure 8 — end-to-end training-step latency under sampled natural
routing — counterpart of ``benchmarks/bench_step.py``.

    PYTHONPATH=src python -m repro_torch.launch.bench_step

The step is modelled as

    step = other + Σ_layers D2C(moe_ffn) × λ

with the unchanged fraction calibrated from the paper's Fig 3 profile
(MoE-FFN ≈ 24% of the step's critical path) and λ a routing-imbalance
factor sampled from a Zipf-flavoured expert distribution. The D2C
latencies are the port's simulator on the real schedules, priced on the
Ascend A3 model: every µs of a row is a prediction of that model, not a
time of the H100 or of any device.
"""

from __future__ import annotations

import numpy as np

from ..core.hardware import AscendA3
from ..core.simulator import simulate_baseline, simulate_unified
from .bench_common import compiled_pair, emit

EPS = (4, 8, 16)
MOE_FRACTION = 0.24       # MoE-FFN share of the step critical path (Fig 3)
PAPER_E2E = {4: 1.08, 8: 1.09, 16: 1.08}


def routing_imbalance(ep: int, e_loc: int, top_k: int = 8,
                      seed: int = 0, n_samples: int = 64) -> float:
    """E[max_rank load / mean load] under Zipf-ish natural routing."""
    rng = np.random.default_rng(seed)
    E = ep * e_loc
    lams = []
    for _ in range(n_samples):
        # aux-loss-balanced natural routing: mild log-normal popularity
        popularity = np.exp(rng.normal(0.0, 0.35, size=E))
        p = popularity / popularity.sum()
        tokens = rng.multinomial(8192 * top_k, p)
        per_rank = tokens.reshape(ep, e_loc).sum(1)
        lams.append(per_rank.max() / per_rank.mean())
    return float(np.mean(lams))


def run(hw: AscendA3 = AscendA3()) -> list[tuple]:
    """Every row ``(name, us, derived)``, each also emitted."""
    rows = []
    for ep in EPS:
        lam = routing_imbalance(ep, 8)
        tot_b, tot_u = 0.0, 0.0
        for direction in ("forward", "backward"):
            s_base, s_opt = compiled_pair(ep, direction)
            tot_b += simulate_baseline(s_base, hw).makespan_us
            tot_u += simulate_unified(s_opt, hw).makespan_us
        # step = other + moe·λ, with moe fraction of the *baseline* step.
        step_base = tot_b * lam / MOE_FRACTION
        other = step_base - tot_b * lam
        step_opt = other + tot_u * lam
        rows += [(f"train_step_ep{ep}_baseline", step_base,
                  f"lambda={lam:.2f}"),
                 (f"train_step_ep{ep}_hyperparallel", step_opt,
                  f"e2e_speedup={step_base / step_opt:.3f}x "
                  f"paper={PAPER_E2E[ep]:.2f}x")]
        for row in rows[-2:]:
            emit(*row)
    return rows


if __name__ == "__main__":
    run()
