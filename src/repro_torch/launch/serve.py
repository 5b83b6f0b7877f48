"""Serving with continuous batching — counterpart of
``repro.launch.serve``.

A request queue feeds fixed-slot batched decoding: a finished sequence
releases its slot to the next request (prefill into the slot; decode goes on
for everyone else). Per-slot cache state lives in one batched cache; a
batch-1 prefill cache is scattered into its slot.

The scheduling options are the reference's: ``--sched`` sizes the
decode-traffic MoE fragment's schedule (``"auto"``: the cost-model
selector); ``--online-refit`` serves the MoE layers through the dropless
fragment with an ``OnlineTuner`` hot-swapping its bucket ladder;
``--slo-us`` arms admission control (defer an admission whose predicted
decode step exceeds the SLO, shed offers past ``--max-queue``). Every µs
they print (``slo``, ``simulated``, ``predicted``) is a prediction of the
Ascend A3 cost model, not a time of the card.

On the card (the default):
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch granite-moe-3b-a800m --requests 16 --slots 8 \\
        --prompt-len 128 --max-new 32 --sched auto --online-refit
On the CPU, at the smoke size:
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --sched auto --online-refit --slo-us 40 --max-queue 16
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from ..core.autoselect import predict_plan_us, select
from ..core.buckets import fit_ladder
from ..core.odg import ScheduleConfig, build_moe_ffn_forward
from ..core.passes import Pipeline, pipeline_arg
from ..core.scheduler import compile_schedule
from ..core.simulator import simulate_unified
from ..device import resolve_device
from ..models import model as M
from ..models.moe import routed_counts
from .dropless import DroplessConfig
from .online import (AdmissionConfig, OnlineMoE, OnlineTuner,
                     population_plan, size_capacity_factor, size_slots)
from .replay import synth_trace


def decode_population(mc, ep: int, n_tokens: int, *, profile: str = "zipf",
                      steps: int = 16, seed: int = 0) -> list[np.ndarray]:
    """Synthesized decode-traffic routing-count population: a short
    correlated Zipf decode trace (``launch/replay.synth_trace``) sized to
    this server's per-step token budget, as exact ``[ep, ep, e_loc]`` count
    matrices. The cold-start stand-in for the online tuner's window."""
    t_loc = max(1, n_tokens // ep)
    trace = synth_trace(profile, steps, ep=ep, e_loc=mc.e_total // ep,
                        t_loc=t_loc, top_k=mc.top_k, seed=seed)
    return [routed_counts(ti, mc, ep) for ti in trace]


def resolve_decode_sched(cfg, sched: str, n_slots: int, plan=None):
    """Size the decode-traffic MoE fragment's schedule for this server.

    Compiles the decode-profile fragment with ``sched`` (``"auto"``
    resolves through ``core.autoselect``), simulates it, prints and returns
    the report ``{"tag", "pipeline", "makespan_us", "predicted_us"}`` — the
    µs of the Ascend A3 model. ``plan`` is the profile (the online tuner's
    ``decode_plan(rows)`` for the live population); by default the
    population mean of :func:`decode_population` at ``n_slots`` tokens.
    Non-MoE archs have no fragment: ``None``.
    """
    if cfg.family != "moe":
        print(f"--sched {sched}: {cfg.name!r} has no MoE fragment; "
              f"scheduling stack not engaged")
        return None
    mc = cfg.moe
    # Decode profile sized to a busy step: every slot decodes one token
    # routed top_k ways.
    rows = max(1, n_slots * mc.top_k)
    if plan is None:
        ep = next(e for e in (4, 2, 1) if mc.e_total % e == 0)
        plan = population_plan(decode_population(mc, ep, max(ep, n_slots)),
                               total_rows=rows)
    ep, e_loc = plan.ep, plan.e_loc
    scfg = ScheduleConfig(ep=ep, e_loc=e_loc, rows=0, d_model=cfg.d_model,
                          d_ff=mc.d_expert, gmm_m_split=2 * ep,
                          gmm_split_mode="source_aligned", plan=plan)
    req = pipeline_arg(sched)
    if req == "auto":
        choice = select(plan, scfg, direction="forward")
        pipe, scfg, tag = choice.pipeline, choice.cfg, choice.tag
        predicted = choice.predicted_us
    else:
        pipe, tag, predicted = Pipeline.of(*req), sched, None
    res = simulate_unified(compile_schedule(build_moe_ffn_forward(scfg),
                                            pipeline=pipe))
    pred = f" predicted={predicted:.1f}us" if predicted is not None else ""
    print(f"decode schedule [{tag}] pipeline={pipe.names()} "
          f"ep={ep} rows/cell={rows} simulated={res.makespan_us:.1f}us"
          f"{pred} straggler={res.straggler_ratio:.2f}")
    return {"tag": tag, "pipeline": pipe.spec(),
            "makespan_us": res.makespan_us, "predicted_us": predicted}


def predict_step_us(cfg, decode_counts, n_active: int, cost=None) -> float:
    """Predicted decode-step µs (the Ascend A3 cost model) at ``n_active``
    busy slots: the ``decode_counts`` population rescaled to that many
    tokens' rows. 0 without a population or for a non-MoE arch."""
    if decode_counts is None or cfg.family != "moe":
        return 0.0
    mc = cfg.moe
    plan = population_plan(decode_counts,
                           total_rows=max(1, n_active) * mc.top_k)
    return predict_plan_us(plan, cfg.d_model, mc.d_expert, cost=cost)


def serving_ep(mc, slots: int, prompt_len: int) -> int:
    """The dropless EP group ``main`` serves with: the largest of 4, 2, 1
    that divides the experts, the slots and the prompt length."""
    return next(e for e in (4, 2, 1) if mc.e_total % e == 0
                and slots % e == 0 and prompt_len % e == 0)


def make_online_moe(cfg, ep: int, decode_counts, cache=None) -> OnlineMoE:
    """``--online-refit``'s MoE: the dropless fragment at ``ep`` (pipeline
    ``ratr``) under an ``OnlineTuner`` seeded with the 6-rung ladder fitted
    on ``decode_counts`` (split penalty 1.0); ``cache=None`` shares the
    process-wide SSC cache, as the reference does."""
    tuner = OnlineTuner(initial=fit_ladder(decode_counts, 6, 1.0),
                        d_model=cfg.d_model, d_ff=cfg.moe.d_expert)
    return OnlineMoE(DroplessConfig(ep=ep, bucket=tuner.spec,
                                    pipeline=("ratr",)), tuner, cache=cache)


class ContinuousBatcher:
    """Fixed-slot continuous batching over a batched KV cache.

    ``moe_impl`` replaces the model's MoE block (default: the kernel-backed
    ``moe_grouped``; ``OnlineMoE(...).impl`` serves through plan-sized
    schedules with live bucket refitting, for which ``n_slots`` and the
    prompt length must be divisible by its ``ep``). Every decode step runs
    the whole slot batch, idle slots included, as the JAX batcher does:
    their tokens take part in routing and in the competition for expert
    capacity. ``admission`` (an ``AdmissionConfig``) arms :meth:`offer`'s
    gate: queue-depth shedding and a predicted-step-latency check priced on
    the ``decode_counts`` population (:func:`predict_step_us`).
    """

    def __init__(self, cfg, params, n_slots: int, max_len: int, *,
                 moe_impl=None, admission=None, decode_counts=None,
                 cost=None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.moe_impl = moe_impl
        self.cache = M.init_cache(cfg, n_slots, max_len, per_slot_len=True,
                                  device=self.device)
        self.active = np.zeros(n_slots, bool)
        self.req_id = [-1] * n_slots
        self.generated: dict[int, list[int]] = {}
        self.budget = np.zeros(n_slots, np.int32)
        self.cur_tok = torch.zeros((n_slots, 1), dtype=torch.long,
                                   device=self.device)
        self.admission = admission
        self.decode_counts = decode_counts
        self.cost = cost
        self.shed: list[int] = []        # shed request ids — reported
        self.deferred = 0                # defer verdicts (retried later)
        self.instant_done: list[int] = []
        self.n_prefills = 0
        self.n_decode_steps = 0
        self.nonfinite_steps = 0     # prefills/steps with a non-finite logit

    def _check_finite(self, logits) -> None:
        if not bool(torch.isfinite(logits).all()):
            self.nonfinite_steps += 1

    def _scatter_slot(self, slot: int, cache1):
        """Write a batch-1 prefill cache into ``slot``: every leaf (keys and
        values, full or ring; conv, ssm and recurrent states) row 0 into
        row ``slot``, and the scalar ``len`` into the per-slot lengths."""
        def scatter(c, c1):
            if isinstance(c, dict):
                for k in c:
                    if k == "len":
                        c[k][slot] = c1[k]
                    else:
                        scatter(c[k], c1[k])
            elif isinstance(c, (list, tuple)):
                for a, b in zip(c, c1):
                    scatter(a, b)
            else:
                c[slot] = c1[0]
        scatter(self.cache, cache1)

    def _predict_step_us(self, n_active: int) -> float:
        """Predicted decode-step µs at ``n_active`` busy slots."""
        return predict_step_us(self.cfg, self.decode_counts, n_active,
                               cost=self.cost)

    def admit(self, rid: int, prompt: np.ndarray, max_new: int) -> bool:
        if max_new > 1 and self.active.all():
            return False
        toks = torch.as_tensor(np.asarray(prompt)[None, :], dtype=torch.long,
                               device=self.device)
        logits, cache1 = M.prefill(self.cfg, self.params, {"tokens": toks},
                                   max_len=self.max_len,
                                   moe_impl=self.moe_impl)
        self.n_prefills += 1
        self._check_finite(logits)
        tok = int(torch.argmax(logits[0]))
        self.generated[rid] = [tok]
        if max_new <= 1:
            # Prefill already produced the whole response: finish without
            # occupying a slot (a slot would decode once more).
            self.instant_done.append(rid)
            return True
        slot = int(np.where(~self.active)[0][0])
        self._scatter_slot(slot, cache1)
        self.cur_tok[slot, 0] = tok
        self.active[slot] = True
        self.req_id[slot] = rid
        self.budget[slot] = max_new - 1
        return True

    def offer(self, rid: int, prompt: np.ndarray, max_new: int,
              queue_depth: int = 0) -> str:
        """Admission-gated :meth:`admit`: ``'admit' | 'defer' | 'shed'``.

        Without an ``AdmissionConfig`` this is admit-or-defer on slot
        availability. With one, an offer with more than ``max_queue``
        requests queued (``queue_depth``) is shed — recorded in
        ``self.shed``, final — and a request whose admission would push the
        predicted decode step past ``slo_us`` is deferred, unless the
        server is idle (the first request always gets in).
        """
        adm = self.admission
        if adm is None:
            if self.admit(rid, prompt, max_new):
                return "admit"
            self.deferred += 1
            return "defer"
        if adm.shed and queue_depth > adm.max_queue:
            self.shed.append(rid)
            return "shed"
        n_active = int(self.active.sum())
        if (max_new > 1 and n_active >= 1
                and self._predict_step_us(n_active + 1) > adm.slo_us):
            self.deferred += 1
            return "defer"
        if self.admit(rid, prompt, max_new):
            return "admit"
        self.deferred += 1
        return "defer"

    def step(self) -> list[int]:
        """One batched decode step over every slot; returns the ids of the
        requests that finished."""
        done, self.instant_done = self.instant_done, []
        if not self.active.any():
            return done
        logits, self.cache = M.decode_step(self.cfg, self.params,
                                           self.cur_tok, self.cache,
                                           moe_impl=self.moe_impl)
        self.n_decode_steps += 1
        self._check_finite(logits)
        nxt = torch.argmax(logits[:, -1], dim=-1)
        self.cur_tok = nxt[:, None]
        nxt = nxt.tolist()
        for s in range(self.n_slots):
            if not self.active[s]:
                continue
            self.generated[self.req_id[s]].append(nxt[s])
            self.budget[s] -= 1
            if self.budget[s] <= 0:
                done.append(self.req_id[s])
                self.active[s] = False
                self.req_id[s] = -1
        return done


def serve(cfg, params, prompts: dict, *, n_slots: int, max_new: int,
          device="cuda", moe_impl=None, admission=None, decode_counts=None,
          cost=None):
    """Serve ``prompts`` ({id: token array}) to the end: every request
    finishes or is reported shed.

    Returns ``(batcher, stats)``. Times are host-clock seconds around each
    prefill and decode step; each ends by reading tokens back to the host,
    which waits for the device.
    """
    prompt_len = max(len(p) for p in prompts.values())
    b = ContinuousBatcher(cfg, params, n_slots=n_slots,
                          max_len=prompt_len + max_new + 1,
                          moe_impl=moe_impl, admission=admission,
                          decode_counts=decode_counts, cost=cost,
                          device=device)
    pending = list(prompts)
    finished: list[int] = []
    verdicts: list[tuple[int, str]] = []
    prefill_s: list[float] = []
    decode_s: list[float] = []
    t0 = time.perf_counter()
    while pending or b.active.any() or b.instant_done:
        while pending:
            t = time.perf_counter()
            verdict = b.offer(pending[0], prompts[pending[0]], max_new,
                              queue_depth=len(pending))
            verdicts.append((pending[0], verdict))
            if verdict == "defer":
                break
            if verdict == "admit":
                prefill_s.append(time.perf_counter() - t)
            pending.pop(0)         # admitted or shed — either way consumed
        busy = b.active.any()
        t = time.perf_counter()
        finished += b.step()
        if busy:
            decode_s.append(time.perf_counter() - t)
        if b.n_decode_steps > 10000:
            raise RuntimeError("serving loop did not converge")
    wall = time.perf_counter() - t0
    if sorted(finished + b.shed) != sorted(prompts):
        raise RuntimeError("a request neither finished nor was reported "
                           "shed")
    tokens = sum(len(v) for v in b.generated.values())
    stats = {
        "requests": len(finished), "shed": len(b.shed),
        "deferred": b.deferred, "tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "prefills": b.n_prefills, "decode_steps": b.n_decode_steps,
        "prefill_ms_median": (1e3 * statistics.median(prefill_s)
                              if prefill_s else None),
        "decode_step_ms_median": (1e3 * statistics.median(decode_s)
                                  if decode_s else None),
        "nonfinite_steps": b.nonfinite_steps,
        "verdicts": verdicts,
    }
    return b, stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite-moe-3b-a800m")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the arch's smoke config instead of the full "
                         "one")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sched", default=None, metavar="PIPELINE",
                    help="size the decode-traffic MoE fragment's schedule "
                         "before serving: 'auto' (cost-model-guided "
                         "selection), a core.passes.SCHED_PIPELINES name, "
                         "or a comma-separated pass list")
    ap.add_argument("--online-refit", action="store_true",
                    help="serve the MoE fragment through plan-sized "
                         "compiled schedules with an OnlineTuner "
                         "observing live routing and hot-swapping the "
                         "bucket ladder (MoE archs only)")
    ap.add_argument("--slo-us", type=float, default=0.0,
                    help="arm admission control: defer admissions whose "
                         "predicted decode-step latency (cost-model "
                         "units) exceeds this, shed past --max-queue")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="queue depth beyond which offers are shed "
                         "(with --slo-us)")
    args = ap.parse_args(argv)

    if args.sched:
        # An unknown pipeline or pass name is an argparse error, for every
        # arch.
        try:
            pipeline_arg(args.sched)
        except KeyError as e:
            ap.error(str(e))

    dev = resolve_device(args.device)
    from ..configs import get_config, get_smoke_config
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    report = {"sched": (resolve_decode_sched(cfg, args.sched, args.slots)
                        if args.sched else None)}

    online = moe_impl = None
    decode_counts = None
    n_slots = args.slots
    admission = None
    if cfg.family == "moe":
        mc = cfg.moe
        ep = serving_ep(mc, args.slots, args.prompt_len)
        decode_counts = decode_population(mc, ep, args.slots)
        report["ep"] = ep
        if args.slo_us > 0:
            admission = AdmissionConfig(slo_us=args.slo_us,
                                        max_queue=args.max_queue)
            sized = size_slots(decode_counts, mc, ep, args.slo_us)
            n_slots = max(ep, min(args.slots, sized))
            cf = size_capacity_factor(decode_counts)
            report["admission"] = {"slo_us": args.slo_us,
                                   "max_queue": args.max_queue,
                                   "sized_slots": sized, "n_slots": n_slots,
                                   "capacity_factor_p99": cf}
            print(f"admission: slo={args.slo_us:.1f}us sized slots="
                  f"{sized} -> serving {n_slots}/{args.slots}, "
                  f"p99 capacity factor={cf:.2f}")
        if args.online_refit:
            if n_slots % ep or args.prompt_len % ep:
                ap.error(f"--online-refit needs slots and prompt-len "
                         f"divisible by ep={ep}")
            online = make_online_moe(cfg, ep, decode_counts)
            moe_impl = online.impl
            print(f"online refit: ep={ep} seed spec={online.tuner.spec}")
    elif args.online_refit:
        print(f"--online-refit: {cfg.name!r} has no MoE fragment; skipped")

    params = M.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    prompts = {i: rng.integers(0, cfg.vocab, args.prompt_len)
               for i in range(args.requests)}
    with torch.inference_mode():
        b, stats = serve(cfg, params, prompts, n_slots=n_slots,
                         max_new=args.max_new, device=dev,
                         moe_impl=moe_impl, admission=admission,
                         decode_counts=decode_counts)
    shed = f", {stats['shed']} shed" if stats["shed"] else ""
    print(f"served {stats['requests']} requests / {stats['tokens']} tokens "
          f"in {stats['wall_s']:.2f}s on {dev} "
          f"({stats['tokens_per_s']:.1f} tok/s) over "
          f"{stats['decode_steps']} decode steps ({n_slots} slots, "
          f"continuous batching{shed})")
    for rid in list(prompts)[:2]:
        if rid in b.generated:
            print(f"  req{rid}: …{prompts[rid][-4:].tolist()} → "
                  f"{b.generated[rid][:10]}…")
    stats["n_slots"] = n_slots
    if online is not None:
        s = online.tuner.summary()
        report["online"] = s
        report["cache"] = {k: v for k, v in online.cache.info().items()
                           if k != "per_entry"}
        print(f"online tuner: steps={s['steps']} refits={s['refits']} "
              f"swaps={s['swaps']} spec={s['spec']} "
              f"selector={s['selector']}")
        if args.sched:
            # Re-resolve the decode schedule from the live rolling
            # population the server just observed.
            rows = max(1, n_slots * cfg.moe.top_k)
            report["sched_live"] = resolve_decode_sched(
                cfg, args.sched, n_slots,
                plan=online.tuner.decode_plan(rows))
    stats["report"] = report
    return b, stats


if __name__ == "__main__":
    main()
