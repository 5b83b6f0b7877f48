"""Decode-trace replay gates — counterpart of ``benchmarks/bench_replay.py``
on the port's ``core/`` and ``launch/{replay,online}.py``.

Host only. The step latencies are the simulator's and the cost model's on
the Ascend A3 model (``core.hardware.AscendA3``), predictions for that
hardware, not measurements of any device; the ``us_per_call`` column of
the replay rows is this host's wall clock per plan fetch. Its rows equal
the reference's but for those wall-clock times.

    PYTHONPATH=src python -m repro_torch.launch.bench_replay

Three gates, each raising when it fails:

* **Bounded retraces.** Churned decode traces (stationary ``uniform``,
  batch-size-bursting ``bursty``) replayed per bucket policy: exact plans
  change the ring's chunk caps on nearly every batch, a fitted ladder's
  caps stay on its rungs (within its rung count + 1 on the stationary
  profile) and far below the step count under bursts.
* **Online against fitted under churn.** Traffic whose volume doubles
  mid-trace (t_loc 48 → 96): the warm-started online tuner must match or
  beat the offline ladder's hit rate on 2 of 3 profiles, keep its mean
  padding no worse than ``linear:16``'s, and hold its simulated p99 within
  10% of the offline policy's.
* **Admission under burst.** The ``bursty`` profile served token by token
  with the gate armed at half the unbounded p99: shed nonzero and reported,
  active tokens within the sized batch, p99 at or under the SLO and below
  the unbounded baseline's, every offered token served, shed or queued.

Rows are CSV ``name,us_per_call,derived``.
"""

from __future__ import annotations

import numpy as np

from ..core.buckets import BucketSpec, fit_ladder
from ..models.moe import MoEConfig, routed_counts
from .bench_common import emit
from .online import AdmissionConfig, replay_admission, size_slots
from .replay import exact_plans, replay_trace, resolve_policies, synth_trace

EP, E_LOC, T_LOC, TOP_K, STEPS = 4, 2, 48, 2, 20
D_MODEL, D_FF = 64, 32

MC = MoEConfig(n_experts=EP * E_LOC, top_k=TOP_K, d_expert=D_FF)


def _trace(profile: str, seed: int):
    return synth_trace(profile, STEPS, ep=EP, e_loc=E_LOC, t_loc=T_LOC,
                       top_k=TOP_K, seed=seed)


def _gate(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def run() -> list[tuple]:
    """Every row ``(name, us, derived)``, each also emitted; raises where
    the reference's gates do."""
    rows = []

    def out(*row):
        rows.append(row)
        emit(*row)

    for profile in ("uniform", "bursty"):
        fitted = fit_ladder(exact_plans(_trace(profile, 1), MC, EP),
                            4, split_penalty=1.0)
        policies = {"exact": BucketSpec.exact(),
                    "linear16": BucketSpec.linear(16),
                    "fitted": fitted}
        res = {r["policy"]: r for r in replay_trace(
            _trace(profile, 0), MC, EP, policies, d_model=D_MODEL,
            d_ff=D_FF, simulate=True)}
        for name, r in res.items():
            out(f"replay_{profile}_{name}", r["fetch_us_mean"],
                f"hit_rate={r['hit_rate']:.2f} "
                f"pad={r['pad_ratio']:.2f}x "
                f"retraces={r['ep_retraces']}/{r['steps']} "
                f"p50={r['p50_us']:.1f}us p99={r['p99_us']:.1f}us "
                f"spec={r['spec']}")

        exact, fit_row = res["exact"], res["fitted"]
        _gate(exact["ep_retraces"] >= 0.9 * STEPS,
              f"{profile}: exact plans should retrace nearly every batch "
              f"({exact['ep_retraces']}/{STEPS})")
        _gate(fit_row["ep_retraces"] < exact["ep_retraces"] / 2,
              f"{profile}: bucketed retraces must be bounded "
              f"({fit_row['ep_retraces']} vs {exact['ep_retraces']})")
        if profile != "bursty":        # bursts legitimately resize caps
            n_rungs = len(fitted.edges)
            _gate(fit_row["ep_retraces"] <= n_rungs + 1,
                  f"{profile}: stationary-profile retraces must stay within "
                  f"the ladder ({fit_row['ep_retraces']} > {n_rungs} + 1)")

    rows += run_online_gate()
    rows += run_admission_gate()
    return rows


def run_online_gate() -> list[tuple]:
    """Online refitting must pay for itself when traffic churns: ``online:6``
    warm-starts from the ladder ``fitted:6`` deploys, so a hit-rate gap is
    the refitting's alone."""
    rows = []
    wins, pad_onl, pad_l16 = 0, [], []
    for profile in ("zipf", "hotspot", "bursty"):
        pre = synth_trace(profile, 32, ep=EP, e_loc=E_LOC, t_loc=T_LOC,
                          top_k=TOP_K, seed=0)
        post = synth_trace(profile, 64, ep=EP, e_loc=E_LOC, t_loc=2 * T_LOC,
                           top_k=TOP_K, seed=2)
        fit = synth_trace(profile, 32, ep=EP, e_loc=E_LOC, t_loc=T_LOC,
                          top_k=TOP_K, seed=1)
        pols = resolve_policies(["linear:16", "fitted:6", "online:6"],
                                fit, MC, EP)
        res = {r["policy"]: r for r in replay_trace(
            pre + post, MC, EP, pols, d_model=D_MODEL, d_ff=D_FF,
            simulate=True)}
        onl, fit_row, l16 = (res["online:6"], res["fitted:6"],
                             res["linear:16"])
        row = (f"replay_churn_{profile}_online", onl["fetch_us_mean"],
               f"hit={onl['hit_rate']:.2f} (fitted={fit_row['hit_rate']:.2f}) "
               f"pad={onl['pad_ratio']:.2f}x (lin16={l16['pad_ratio']:.2f}x) "
               f"swaps={onl['swaps']} refits={onl['refits']} "
               f"p99={onl['p99_us']:.1f}us (fitted={fit_row['p99_us']:.1f}us)")
        rows.append(row)
        emit(*row)
        wins += onl["hit_rate"] >= fit_row["hit_rate"]
        pad_onl.append(onl["pad_ratio"])
        pad_l16.append(l16["pad_ratio"])
        _gate(onl["p99_us"] <= 1.10 * fit_row["p99_us"],
              f"{profile}: online p99 {onl['p99_us']:.2f}us regressed >10% "
              f"over fitted {fit_row['p99_us']:.2f}us")
    _gate(wins >= 2, f"online matched/beat the offline fit on only {wins}/3 "
                     f"churned profiles")
    _gate(float(np.mean(pad_onl)) <= float(np.mean(pad_l16)),
          f"online mean pad {np.mean(pad_onl):.3f}x exceeds the static "
          f"linear:16 ladder's {np.mean(pad_l16):.3f}x")
    return rows


def run_admission_gate() -> list[tuple]:
    """Admission control must buy its p99 with reported shed: bursty
    traffic, the SLO at half the unbounded baseline's p99, the batch budget
    sized from the same trace (``size_slots``)."""
    trace = synth_trace("bursty", 48, ep=EP, e_loc=E_LOC, t_loc=32,
                        top_k=TOP_K, seed=0)
    base = replay_admission(trace, MC, EP, d_model=D_MODEL, d_ff=D_FF)
    slo = 0.5 * base["p99_us"]
    pop = [routed_counts(ti, MC, EP) for ti in trace]
    n = size_slots(pop, MC, EP, slo, d_model=D_MODEL, d_ff=D_FF)
    gated = replay_admission(
        trace, MC, EP, d_model=D_MODEL, d_ff=D_FF, n_slots=n,
        admission=AdmissionConfig(slo_us=slo, max_queue=160))
    row = ("replay_admission_gated", gated["p99_us"],
           f"slo={slo:.2f}us n_slots={n} shed={gated['shed']} "
           f"served={gated['served']} deferred={gated['deferred']} "
           f"max_active={gated['max_active']} "
           f"base_p99={base['p99_us']:.2f}us "
           f"miss={gated['slo_miss_rate']:.2f}")
    emit(*row)
    offered = sum(np.asarray(t).reshape(-1, np.asarray(t).shape[-1]).shape[0]
                  for t in trace)
    _gate(gated["served"] + gated["shed"] + gated["deferred"] == offered,
          "token accounting leak: served+shed+deferred != offered")
    _gate(gated["shed"] > 0, "bursty load at half-p99 SLO must shed")
    _gate(gated["max_active"] <= n,
          f"gate exceeded sized budget: {gated['max_active']} > {n}")
    _gate(gated["p99_us"] <= slo < base["p99_us"],
          f"gated p99 {gated['p99_us']:.2f}us vs slo {slo:.2f}us vs "
          f"baseline {base['p99_us']:.2f}us")
    return [row]


if __name__ == "__main__":
    run()
