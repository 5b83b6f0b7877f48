"""Decode-trace replay: bucket policies under serving-shaped traffic —
counterpart of ``repro.launch.replay``, on the port's own ``core/``.

Replays decode traces (one ``[T, k]`` top-k choice array per step) through
the plan-compilation path (``plan_from_routing`` → bucketed ``RoutingPlan``
→ ``SSCCache`` → ``compile_schedule``) and prices every step's schedule
with ``simulate_unified``, reporting per bucket policy the SSC hit and
recompile rates, the padding ratio, the distinct ``ring_chunk_caps``
tuples (``ep_retraces``: how often a plan-sized EP ring step would be
rebuilt) and the simulated step latency. Host only: the latencies are the
discrete-event simulator's on the Ascend A3 model
(``core.hardware.AscendA3``), a prediction for that hardware, not a
measurement of any device; ``fetch_us_mean`` is this host's wall clock.

Traces are synthesized (``--profile uniform|zipf|hotspot|bursty``; the
same numpy ``default_rng`` call sequence as the reference, so the traces
are equal array for array) or recorded in the reference's JSONL format:
one ``{"step": i, "top_i": [[e, e], ...]}`` object per decode step, with an
optional ``"t_us"`` arrival time (monotone µs). With arrivals and
``--slo-us``, a busy-server model (a step starts at ``max(arrival,
previous completion)``) adds response-time percentiles and the SLO miss
rate.

Policies are ``BucketSpec`` forms, ``fitted:B[xL]`` (a ladder fitted
offline on held-out data) or ``online[:B[xL]]`` (an
``launch.online.OnlineTuner`` warm-started from the same fit, refitting on
the replayed traffic).

    PYTHONPATH=src python -m repro_torch.launch.replay --profile bursty \
        --steps 64 --policies exact,linear:16,geometric:8,fitted:6
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np

from ..core.buckets import BucketSpec, fit_ladder
from ..core.odg import ScheduleConfig
from ..core.simulator import simulate_unified
from ..core.ssc import SSCCache
from ..models.moe import MoEConfig, plan_from_routing, routed_counts
from ..parallel.ep import ring_chunk_caps
from .online import OnlineConfig, OnlineTuner

PROFILES = ("uniform", "zipf", "hotspot", "bursty")


# ---------------------------------------------------------------------------
# Trace synthesis + the recorded-trace JSONL format.
# ---------------------------------------------------------------------------

def _expert_probs(profile: str, e: int, hot: int = 0) -> np.ndarray:
    if profile == "uniform":
        p = np.ones(e)
    elif profile == "zipf":
        p = np.arange(1, e + 1, dtype=np.float64) ** -1.2
    elif profile == "hotspot":
        p = np.full(e, 0.3 / max(1, e - 1))
        p[hot % e] = 0.7
    elif profile == "bursty":
        # Mild skew plus a rotating hot expert (hot prompt prefixes).
        p = np.full(e, 0.7 / max(1, e - 1))
        p[hot % e] = 0.3
    else:
        raise ValueError(f"unknown profile {profile!r}; choices: {PROFILES}")
    return p / p.sum()


def _gumbel_topk(rng: np.random.Generator, probs: np.ndarray, t: int,
                 k: int) -> np.ndarray:
    """[t, k] distinct expert choices per token (Gumbel top-k)."""
    g = rng.gumbel(size=(t, probs.shape[0]))
    pert = np.log(probs)[None, :] + g
    return np.argsort(-pert, axis=1)[:, :k]


def synth_trace(profile: str, steps: int, *, ep: int = 4, e_loc: int = 2,
                t_loc: int = 64, top_k: int = 2, seed: int = 0,
                churn: float = 0.12) -> list[np.ndarray]:
    """Synthesize a decode trace: one [T_t, k] top-k choice array per step.

    Successive decode batches are *correlated* — continuous batching swaps
    only the slots that finished or arrived, the rest keep decoding — so
    every profile churns a ``churn`` fraction of token choices per step
    instead of resampling the whole batch (uncorrelated jitter wildly
    overstates recompile pressure). ``uniform``/``zipf``/``hotspot`` hold
    the batch at ``ep * t_loc`` tokens and churn only the routing.
    ``bursty`` is the hard serving case: the active token count follows a
    burst-arrival/drain envelope (slots fill on a burst, drain
    geometrically) and the hot expert rotates slowly — batch-size *and*
    routing jitter at once. Token counts stay multiples of ``ep``.
    """
    rng = np.random.default_rng(seed)
    e = ep * e_loc
    base_t = ep * t_loc
    trace: list[np.ndarray] = []

    def draw(t: int, probs: np.ndarray) -> np.ndarray:
        return _gumbel_topk(rng, probs, t, top_k)

    # The resident token pool: churn re-routes a fraction of it per step;
    # bursty replays an active prefix whose length follows the envelope.
    pool = draw(base_t, _expert_probs(profile, e, hot=0))
    env = 0.6
    for step in range(steps):
        probs = _expert_probs(profile, e,
                              hot=step // 8 if profile == "bursty" else 0)
        n = max(1, int(round(churn * base_t)))
        idx = rng.choice(base_t, size=n, replace=False)
        pool = pool.copy()
        pool[idx] = draw(n, probs)
        if profile == "bursty":
            if rng.random() < 0.2:
                env = rng.uniform(0.5, 1.0)          # burst: slots fill
            else:
                env = max(0.2, env * rng.uniform(0.8, 0.95))   # drain
            t = max(ep, int(round(base_t * env / ep)) * ep)
        else:
            t = base_t
        trace.append(pool[:t].copy())
    return trace


def synth_arrival_us(trace: Sequence[np.ndarray], *,
                     mean_gap_us: float = 500.0,
                     seed: int = 0) -> np.ndarray:
    """Per-step arrival timestamps consistent with a trace's batch sizes.

    A bigger offered batch means the inter-arrival gap that accumulated it
    was shorter, so gaps scale inversely with each step's token count
    around ``mean_gap_us`` (± jitter) — bursty traces get clustered
    arrivals, fixed-size traces an almost-fixed cadence. Monotone
    non-decreasing µs, deterministic per seed.
    """
    rng = np.random.default_rng(seed)
    tokens = np.asarray([np.asarray(t).reshape(-1, np.asarray(t).shape[-1])
                         .shape[0] for t in trace], dtype=np.float64)
    gaps = mean_gap_us * (tokens.mean() / np.maximum(tokens, 1.0))
    gaps *= rng.uniform(0.8, 1.2, size=gaps.shape)
    return np.cumsum(gaps)


def save_trace_jsonl(path: str, trace: Sequence[np.ndarray],
                     arrival_us: Optional[Sequence[float]] = None) -> None:
    """Write the recorded-trace JSONL; ``arrival_us`` (optional, one per
    step) adds the backward-compatible ``"t_us"`` timestamp field."""
    if arrival_us is not None and len(arrival_us) != len(trace):
        raise ValueError(
            f"arrival_us has {len(arrival_us)} entries for "
            f"{len(trace)} steps")
    with open(path, "w") as f:
        for i, top_i in enumerate(trace):
            obj = {"step": i, "top_i": np.asarray(top_i).tolist()}
            if arrival_us is not None:
                obj["t_us"] = float(arrival_us[i])
            f.write(json.dumps(obj) + "\n")


def load_trace_jsonl(path: str, with_arrivals: bool = False):
    """Load a recorded trace; default return is the plain step list.

    ``with_arrivals=True`` returns ``(trace, arrival_us)`` where
    ``arrival_us`` is a float64 array when *every* step carries ``t_us``
    and ``None`` otherwise (absent ⇒ fixed cadence, the legacy format).
    """
    trace, arrivals = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            trace.append(np.asarray(obj["top_i"], dtype=np.int64))
            arrivals.append(obj.get("t_us"))
    if not trace:
        raise ValueError(f"{path}: empty trace")
    if not with_arrivals:
        return trace
    arr = (np.asarray(arrivals, dtype=np.float64)
           if all(a is not None for a in arrivals) else None)
    return trace, arr


# ---------------------------------------------------------------------------
# Policy resolution (incl. fitting ladders from a trace).
# ---------------------------------------------------------------------------

def exact_plans(trace: Sequence[np.ndarray], mc, ep: int) -> list:
    """The unbucketed per-step RoutingPlans — fit_ladder's population."""
    return [plan_from_routing(ti, mc, ep, capacity=None).plan
            for ti in trace]


def resolve_policies(specs: Sequence[str], fit_trace, mc,
                     ep: int) -> dict:
    """Map CLI policy names to specs (or online tuners).

    ``fitted:B`` fits a B-rung ladder on ``fit_trace`` (use a *different*
    seed/segment than the replayed trace, or the fit is evaluated
    in-sample); ``fitted:BxL`` additionally sets the fit's
    ``split_penalty`` to L (0 = padding-optimal, larger = reuse-favoring).
    ``online[:B[xL]]`` builds an
    :class:`~repro_torch.launch.online.OnlineTuner`
    with that ladder budget / split penalty, *warm-started* from the same
    offline fit ``fitted:B`` would deploy (the realistic rollout: ship the
    deploy-time ladder, let the tuner take over) — comparing ``online:B``
    against ``fitted:B`` on one trace therefore isolates exactly the value
    of online refitting.
    """
    plans = None
    out: dict = {}
    for s in specs:
        s = s.strip()
        if not s:
            continue
        if s.startswith("fitted") or s.startswith("online"):
            params = s.partition(":")[2] or "6"
            b, _, lam = params.partition("x")
            if plans is None:
                plans = exact_plans(fit_trace, mc, ep)
            seed_spec = fit_ladder(plans, int(b),
                                   split_penalty=float(lam) if lam else 0.5)
            if s.startswith("online"):
                oc = OnlineConfig(budget=int(b), **(
                    {"split_penalty": float(lam)} if lam else {}))
                out[s] = OnlineTuner(initial=seed_spec, oc=oc)
            else:
                out[s] = seed_spec
        else:
            out[s] = BucketSpec.parse(s)
    if not out:
        raise ValueError("no bucket policies given")
    return out


# ---------------------------------------------------------------------------
# The replay loop.
# ---------------------------------------------------------------------------

def replay_trace(trace: Sequence[np.ndarray], mc, ep: int,
                 policies: dict, *,
                 d_model: int = 64, d_ff: Optional[int] = None,
                 pipeline: Sequence = ("ratr",),
                 directions: Sequence[str] = ("forward",),
                 gmm_m_split: int = 1, simulate: bool = True,
                 max_entries: int = 1024, quiet: bool = True,
                 arrival_us: Optional[Sequence[float]] = None,
                 slo_us: Optional[float] = None) -> list[dict]:
    """Replay one trace under each bucket policy; one result row per policy.

    Every step builds the policy's bucketed plan, fetches (or compiles) its
    schedule(s) from a fresh per-policy ``SSCCache``, tracks the EP-ring
    cap signature, and — with ``simulate`` — prices the step's schedule on
    the simulator (memoized per distinct plan, so the wall cost scales with
    *distinct* schedules, exactly like the real system's compile cost).
    Decode replay prices ``("forward",)``; pass both directions for
    training-shaped traces.

    A policy value may be an :class:`~repro_torch.launch.online.OnlineTuner`
    instead of a static spec: each step's exact routing counts are fed to
    ``observe`` and the step is quantized with whatever spec the tuner
    currently holds (its result row adds ``swaps``/``refits``).

    ``arrival_us`` (with ``simulate``) adds arrival-time-accurate serving
    latency under a busy-server model — step *i* starts at
    ``max(arrival_us[i], completion[i-1])`` and its response time spans
    arrival → completion — reported as ``p50_resp_us``/``p99_resp_us``
    plus ``slo_miss_rate`` when ``slo_us`` is set.
    """
    d_ff = d_ff if d_ff is not None else mc.d_expert
    if arrival_us is not None and len(arrival_us) != len(trace):
        raise ValueError(f"arrival_us has {len(arrival_us)} entries for "
                         f"{len(trace)} steps")
    rows_out = []
    for name, pol in policies.items():
        tuner = pol if isinstance(pol, OnlineTuner) else None
        spec = None if tuner else pol
        cache = SSCCache(max_entries=max_entries)
        if tuner is not None:
            tuner.bind(cache=cache, d_model=d_model, d_ff=d_ff)
        sims: dict[tuple, float] = {}
        lat_us: list[float] = []
        fetch_s: list[float] = []
        ring_sigs: set[tuple] = set()
        for top_i in trace:
            t0 = time.perf_counter()
            if tuner is not None:
                spec = tuner.observe(routed_counts(top_i, mc, ep))
            bridge = plan_from_routing(top_i, mc, ep, capacity=None,
                                       bucket=spec)
            plan = bridge.plan
            cache.record_rows(int(bridge.send_row.size), plan.total_rows)
            ring_sigs.add(ring_chunk_caps(plan, ep))
            cfg = ScheduleConfig(ep=ep, e_loc=plan.e_loc, rows=0,
                                 d_model=d_model, d_ff=d_ff,
                                 gmm_m_split=gmm_m_split,
                                 gmm_split_mode="source_aligned",
                                 plan=plan, bucket=spec.key())
            step_us = 0.0
            scheds = {direction: cache.get_or_compile(
                cfg, direction, pipeline=list(pipeline))
                for direction in directions}
            # Timed span = plan build + fetch-or-compile only; simulator
            # pricing below is measurement, not per-step scheduling cost.
            fetch_s.append(time.perf_counter() - t0)
            if simulate:
                for direction, sched in scheds.items():
                    sk = (plan.counts, direction)
                    if sk not in sims:
                        sims[sk] = simulate_unified(sched).makespan_us
                    step_us += sims[sk]
            lat_us.append(step_us)
        info = cache.info()
        total = info["hits"] + info["misses"]
        row = {
            "policy": name,
            "spec": str(spec),
            "steps": len(trace),
            "hit_rate": info["hits"] / total if total else 0.0,
            "recompile_rate": info["misses"] / total if total else 0.0,
            "compiles": info["misses"],
            "pad_ratio": info["pad_ratio"],
            "ep_retraces": len(ring_sigs),
            "fetch_us_mean": 1e6 * float(np.mean(fetch_s)),
        }
        if tuner is not None:
            row["swaps"] = len(tuner.swaps)
            row["refits"] = tuner.refits
        if simulate:
            row["p50_us"] = float(np.percentile(lat_us, 50))
            row["p99_us"] = float(np.percentile(lat_us, 99))
            if arrival_us is not None:
                resp, end = [], 0.0
                for arr, us in zip(arrival_us, lat_us):
                    end = max(float(arr), end) + us
                    resp.append(end - float(arr))
                row["p50_resp_us"] = float(np.percentile(resp, 50))
                row["p99_resp_us"] = float(np.percentile(resp, 99))
                if slo_us is not None:
                    row["slo_miss_rate"] = float(
                        (np.asarray(resp) > slo_us).mean())
        rows_out.append(row)
        if not quiet:
            sim = (f" p50={row['p50_us']:8.1f}us p99={row['p99_us']:8.1f}us"
                   if simulate else "")
            if "p99_resp_us" in row:
                sim += f" p99resp={row['p99_resp_us']:8.1f}us"
            swaps = f" swaps={row['swaps']}" if tuner is not None else ""
            print(f"[replay {name:14s}] hit={row['hit_rate']:.2f} "
                  f"pad={row['pad_ratio']:.2f}x "
                  f"retraces={row['ep_retraces']:3d}/{len(trace)} "
                  f"compiles={row['compiles']:3d}{sim}{swaps} ({spec})")
    return rows_out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="replay decode traces through plan compilation + the "
                    "simulator, comparing bucket policies")
    ap.add_argument("--profile", default="bursty", choices=PROFILES,
                    help="synthetic trace profile (ignored with --trace-in)")
    ap.add_argument("--trace-in", default=None, metavar="JSONL",
                    help="recorded decode trace (one {'top_i': [[e,..],..]} "
                         "object per step) instead of a synthetic profile")
    ap.add_argument("--trace-out", default=None, metavar="JSONL",
                    help="record the replayed trace in the JSONL format")
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--ep", type=int, default=4)
    ap.add_argument("--experts", type=int, default=8,
                    help="total experts (e_loc = experts / ep)")
    ap.add_argument("--t-loc", type=int, default=64,
                    help="peak tokens per source rank")
    ap.add_argument("--top-k", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--d-ff", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--churn", type=float, default=0.12,
                    help="fraction of token choices re-routed per step "
                         "(continuous-batching slot turnover)")
    ap.add_argument("--policies", default="exact,linear:16,geometric:8,"
                                          "fitted:6",
                    help="comma-separated bucket policies; 'fitted:B[xL]' "
                         "fits a B-rung ladder (split_penalty L) on held-"
                         "out data: a seed+1 trace for synthetic profiles, "
                         "or the first half of --trace-in (all policies "
                         "then replay only the second half)")
    ap.add_argument("--directions", default="forward",
                    help="comma-separated schedule directions to fetch "
                         "(decode = forward; training traces: "
                         "forward,backward)")
    ap.add_argument("--no-sim", action="store_true",
                    help="skip the simulator (cache/retrace stats only)")
    ap.add_argument("--arrival-gap-us", type=float, default=0.0,
                    help="synthesize per-step arrival timestamps at this "
                         "mean inter-step gap (0 = off); recorded traces "
                         "with t_us fields carry their own arrivals")
    ap.add_argument("--slo-us", type=float, default=None,
                    help="response-time SLO bound (µs); with arrivals, "
                         "rows gain slo_miss_rate")
    ap.add_argument("--report-out", default=None, metavar="JSONL",
                    help="write one result row per policy as JSONL")
    args = ap.parse_args(argv)

    if args.experts % args.ep:
        ap.error(f"--experts {args.experts} not divisible by --ep {args.ep}")
    e_loc = args.experts // args.ep
    mc = MoEConfig(n_experts=args.experts, top_k=args.top_k,
                   d_expert=args.d_ff)

    wants_fit = any(s.strip().startswith("fitted")
                    for s in args.policies.split(","))
    arrivals = None
    if args.trace_in:
        trace, arrivals = load_trace_jsonl(args.trace_in,
                                           with_arrivals=True)
        if wants_fit:
            # A recorded trace has no second seed to draw from: fit on the
            # first half and replay *only* the held-out second half (for
            # every policy, so rows stay comparable) — otherwise fitted
            # hit/pad rows would be partly in-sample and look better than
            # they generalize.
            if len(trace) < 2:
                ap.error("--trace-in with a fitted policy needs >= 2 steps "
                         "(fit half + held-out half)")
            split = len(trace) // 2
            fit_trace, trace = trace[:split], trace[split:]
            if arrivals is not None:
                arrivals = arrivals[split:]
            print(f"fitted policies: fit on steps [0, {split}), replaying "
                  f"held-out steps [{split}, {split + len(trace)})")
        else:
            fit_trace = trace
    else:
        trace = synth_trace(args.profile, args.steps, ep=args.ep,
                            e_loc=e_loc, t_loc=args.t_loc,
                            top_k=args.top_k, seed=args.seed,
                            churn=args.churn)
        fit_trace = synth_trace(args.profile, args.steps, ep=args.ep,
                                e_loc=e_loc, t_loc=args.t_loc,
                                top_k=args.top_k, seed=args.seed + 1,
                                churn=args.churn)
    if arrivals is None and args.arrival_gap_us > 0:
        arrivals = synth_arrival_us(trace, mean_gap_us=args.arrival_gap_us,
                                    seed=args.seed)
    if args.trace_out:
        save_trace_jsonl(args.trace_out, trace, arrival_us=arrivals)

    policies = resolve_policies(args.policies.split(","), fit_trace, mc,
                                args.ep)
    rows = replay_trace(
        trace, mc, args.ep, policies, d_model=args.d_model, d_ff=args.d_ff,
        directions=tuple(d for d in args.directions.split(",") if d),
        simulate=not args.no_sim, quiet=False,
        arrival_us=arrivals, slo_us=args.slo_us)
    if args.report_out:
        with open(args.report_out, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return rows


if __name__ == "__main__":
    main()
