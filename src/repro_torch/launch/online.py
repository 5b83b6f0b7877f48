"""Self-tuning SLO-aware serving: online bucket/selector refitting —
counterpart of ``repro.launch.online``, on the port's own ``core/``.

* :class:`OnlineTuner` keeps a rolling window of exact routing-count
  matrices from served batches, refits the ``BucketSpec`` ladder
  (``fit_ladder``) every ``refit_every`` observations, re-prices the
  pipeline selector, and hot-swaps the spec only when the candidate's
  predicted padding + recompile cost beats the incumbent's by the
  hysteresis margin. A swap re-keys the SSC cache
  (``SSCCache.rekey_for_bucket``) and never flushes it.
* :class:`OnlineMoE` is the serving twin of ``launch/dropless.DroplessMoE``:
  the same fragment, built with the ``live=`` seam, so every forward
  observes its batch's exact routing into the tuner and runs under the
  tuner's current spec. On the card the fragment's fp32 ``gmm`` calls sum
  each output in one ascending-k chain whatever the call's row count, so a
  swap, which only changes how plan cells pad, leaves the served tokens
  bit for bit. (On the CPU ``torch.bmm``'s bits may depend on the row
  count, as the reference's XLA dot's do.)
* :class:`AdmissionConfig`, :func:`replay_admission`, :func:`size_slots`
  and :func:`size_capacity_factor`: replay-driven batch and
  capacity-factor sizing, and a queue-depth + predicted-step-latency
  admission gate with load shedding, simulated at the token level.

Everything but :class:`OnlineMoE` works on count matrices and the
compile-time cost model: its µs are predictions of the Ascend A3 model
(``core.hardware.AscendA3``), not times of any device.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..core.autoselect import AutoChoice, predict_plan_us, select
from ..core.buckets import BucketSpec, fit_ladder
from ..core.costmodel import CostModel
from ..core.odg import ScheduleConfig
from ..core.routing import RoutingPlan
from ..models.moe import routed_counts
from .dropless import _make_impl, get_process_cache


# ---------------------------------------------------------------------------
# Rolling-population plan derivation.
# ---------------------------------------------------------------------------


def population_plan(counts_pop: Sequence[np.ndarray],
                    total_rows: Optional[int] = None) -> RoutingPlan:
    """Representative :class:`RoutingPlan` of a plan population.

    Per-cell mean over the population, rounded up (so the profile keeps
    every expert the population ever touched — sparsity of the *union*,
    skew of the mean). ``total_rows`` rescales the mean to a target row
    count before rounding — the decode-profile case, where the population
    was observed at serving batch size B but the schedule being sized runs
    at ``n_slots * top_k`` rows.
    """
    mats = [np.asarray(c, dtype=np.int64) for c in counts_pop]
    if not mats:
        raise ValueError("population_plan needs a non-empty population")
    mean = np.mean(np.stack(mats), axis=0)
    if total_rows is not None:
        s = float(mean.sum())
        if s > 0:
            mean = mean * (float(total_rows) / s)
    c = np.ceil(mean).astype(np.int64)
    if c.sum() == 0:
        raise ValueError("population_plan: population routes zero rows")
    return RoutingPlan.from_counts(c)


# ---------------------------------------------------------------------------
# The online tuner.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OnlineConfig:
    """Knobs of the refit/swap loop (see :class:`OnlineTuner`)."""

    window: int = 32          # rolling population size (served batches)
    refit_every: int = 8      # observations between refit attempts
    min_window: int = 8       # no refit before this many observations
    budget: int = 6           # fit_ladder edge budget
    # Online refits favor reuse a notch harder than the offline default
    # (0.5): a live candidate pays its own compiles, so flip-prone tight
    # ladders must not even be proposed.
    split_penalty: float = 1.0
    # Swap only when the candidate's predicted window cost undercuts the
    # incumbent's by this fraction — the anti-thrash margin. 0 = greedy.
    hysteresis: float = 0.1
    # The swap criterion is priced in *row-equivalents* (padding rows are
    # the natural unit; a padded row is dispatched and multiplied like a
    # real one). One fresh schedule compile+fetch then costs
    # ``compile_step_ratio`` steps' worth of mean window rows — the
    # scale-free form of "a compile costs a couple of served steps"
    # (bench_dropless: SSC fetch ~2.5 ms vs a served step's ~ms). Setting
    # ``row_us`` *and* ``compile_us`` (µs) overrides the ratio with an
    # absolute measured pair.
    compile_step_ratio: float = 1.0
    row_us: Optional[float] = None
    compile_us: Optional[float] = None

    def __post_init__(self):
        if self.window < 1 or self.refit_every < 1 or self.min_window < 1:
            raise ValueError("window/refit_every/min_window must be >= 1")
        if not 0.0 <= self.hysteresis < 1.0:
            raise ValueError(
                f"hysteresis must be in [0, 1), got {self.hysteresis}")


class OnlineTuner:
    """Online bucket-ladder refitting with hysteresis-gated hot swaps.

    ``observe(counts)`` feeds one served batch's exact ``[ep, ep, e_loc]``
    routing counts (``models.moe.routed_counts``) into the rolling window
    and returns the spec the batch should be quantized with. Every
    ``refit_every`` observations (once ``min_window`` is reached) the tuner
    fits a candidate ladder on the window and prices both specs over it in
    row-equivalents::

        cost(spec) = padded_rows(window) + compiles(spec) * compile_rows

    where ``compile_rows`` prices one fresh compile (see
    :class:`OnlineConfig`) and ``compiles`` is asymmetric, exactly the
    asymmetry a hot swap faces: the *incumbent* served the window, so its
    window keys are warm — it only pays its ongoing key-novelty rate
    (distinct keys appearing in the window's second half that its first
    half never produced, scaled to the full window); the *challenger*
    pays its cold fill (every distinct key its quantization of the window
    produces) plus the same novelty rate. An ``exact`` incumbent under
    churn is thereby correctly charged per new routing, while a coarse
    warm incumbent is nearly free to keep. The swap fires only when
    ``cand < (1 - hysteresis) * incumbent``; each swap re-keys the SSC
    cache (never flushes — the old policy's blobs stay bit-correct and the
    ladder may swap back) and re-prices the pipeline selector against the
    window's population profile. Decisions are pure functions of the
    observation sequence — two tuners fed the same window agree.
    """

    def __init__(self, initial="geometric:8",
                 oc: Optional[OnlineConfig] = None, *,
                 cache=None, cost: Optional[CostModel] = None,
                 d_model: int = 64, d_ff: int = 32):
        self.spec = BucketSpec.from_any(initial)
        self.oc = oc if oc is not None else OnlineConfig()
        self.cache = cache
        self.cost = cost if cost is not None else CostModel(l2=False)
        self.d_model = int(d_model)
        self.d_ff = int(d_ff)
        self.window: collections.deque = collections.deque(
            maxlen=self.oc.window)
        self.steps = 0
        self.refits = 0
        self.swaps: list[dict] = []
        self.choice: Optional[AutoChoice] = None   # last selector re-pricing

    def bind(self, *, cache=None, cost: Optional[CostModel] = None,
             d_model: Optional[int] = None,
             d_ff: Optional[int] = None) -> "OnlineTuner":
        """Late-bind serving context (cache, cost model, layer sizing) —
        the replay/serve loops construct tuners before either is known."""
        if cache is not None:
            self.cache = cache
        if cost is not None:
            self.cost = cost
        if d_model is not None:
            self.d_model = int(d_model)
        if d_ff is not None:
            self.d_ff = int(d_ff)
        return self

    # -- the observation loop ------------------------------------------------

    def observe(self, counts) -> BucketSpec:
        """Feed one batch's exact routing counts; returns the active spec."""
        self.window.append(np.asarray(counts, dtype=np.int64))
        self.steps += 1
        if (self.steps % self.oc.refit_every == 0
                and len(self.window) >= self.oc.min_window):
            self.maybe_refit()
        return self.spec

    # -- refit / swap machinery ----------------------------------------------

    def _compile_rows(self) -> float:
        """Row-equivalent price of one fresh schedule compile."""
        oc = self.oc
        if oc.row_us is not None and oc.compile_us is not None:
            return oc.compile_us / oc.row_us
        mean_rows = float(np.mean([int(c.sum()) for c in self.window]))
        return oc.compile_step_ratio * mean_rows

    def policy_cost(self, spec: BucketSpec, *, warm: bool) -> float:
        """Predicted window cost of ``spec`` in row-equivalents.

        ``warm`` is the incumbent's position: its window keys were
        compiled while serving the window, so it pays only its ongoing
        key-novelty rate; a cold challenger pays its full cold fill plus
        the same novelty rate (see class docstring).
        """
        pad = 0
        keys: list[bytes] = []
        for c in self.window:
            q = spec.quantize(c)
            pad += int(q.sum() - c.sum())
            keys.append(q.tobytes())
        half = len(keys) // 2
        novel = len(set(keys[half:]) - set(keys[:half])) * 2
        fresh = novel if warm else len(set(keys)) + novel
        return pad + fresh * self._compile_rows()

    def maybe_refit(self) -> bool:
        """Fit a candidate ladder on the window; swap iff it clears the
        hysteresis margin. Returns whether a swap happened."""
        self.refits += 1
        cand = fit_ladder(list(self.window), self.oc.budget,
                          self.oc.split_penalty)
        if cand.key() == self.spec.key():
            self._reprice()
            return False
        inc_cost = self.policy_cost(self.spec, warm=True)
        cand_cost = self.policy_cost(cand, warm=False)
        if cand_cost < (1.0 - self.oc.hysteresis) * inc_cost:
            self.swap_to(cand, inc_cost=inc_cost, cand_cost=cand_cost)
            return True
        self._reprice()
        return False

    def swap_to(self, spec, **evidence) -> None:
        """Hot-swap the active spec (also the forced-swap test seam).

        The spec only changes how plan cells pad, and padding rows are
        inert in the executor; on the card each fp32 ``gmm`` output is one
        ascending-k chain whatever the tile's row count, so the swap keeps
        served tokens bit for bit (on the CPU, within rounding). The SSC
        cache re-keys (MRU-boosts the new policy's resident population —
        never flushes) so the swap costs at most fresh compiles, not
        correctness.
        """
        spec = BucketSpec.from_any(spec)
        event = {"step": self.steps, "from": str(self.spec),
                 "to": str(spec), **evidence}
        self.spec = spec
        if self.cache is not None:
            event["rekey"] = self.cache.rekey_for_bucket(spec)
        self.swaps.append(event)
        self._reprice()

    def _reprice(self) -> None:
        """Re-price the pipeline selector on the window's profile."""
        if not self.window:
            return
        plan = population_plan(self.window)
        cfg = ScheduleConfig(ep=plan.ep, e_loc=plan.e_loc, rows=0,
                             d_model=self.d_model, d_ff=self.d_ff,
                             gmm_split_mode="source_aligned", plan=plan)
        self.choice = select(plan, cfg, self.cost, direction="forward")

    # -- consumers -----------------------------------------------------------

    def decode_plan(self, total_rows: Optional[int] = None) -> RoutingPlan:
        """Decode-profile plan derived from the rolling population."""
        return population_plan(self.window, total_rows=total_rows)

    def summary(self) -> dict:
        return {"steps": self.steps, "refits": self.refits,
                "swaps": len(self.swaps), "spec": str(self.spec),
                "selector": self.choice.tag if self.choice else None}


# ---------------------------------------------------------------------------
# Live-swapping dropless MoE (the serving executor).
# ---------------------------------------------------------------------------


class OnlineMoE:
    """Dropless MoE whose bucket spec hot-swaps under the online tuner.

    The same fragment as ``DroplessMoE`` (``top_i`` to the host, the
    plan-sized schedule on x's device), built with the ``live=`` seam: each
    forward observes the batch's exact routing (host ``top_i``, [T, k])
    into the tuner and runs under whatever spec the tuner then holds.
    Only the bucket spec changes across swaps; the mesh size, tiling and
    pipeline are pinned at construction.
    """

    def __init__(self, dc, tuner: OnlineTuner, act: str = "swiglu",
                 cache=None):
        if act != "swiglu":
            raise ValueError(
                f"dropless schedules execute the SwiGLU fragment; act={act!r}")
        self.cache = cache if cache is not None else get_process_cache(
            dc.cache_entries)
        self.tuner = tuner.bind(cache=self.cache)
        self._dc = dataclasses.replace(dc, bucket=self.tuner.spec)
        self.impl = _make_impl(self._dc, self.cache, live=self._live)

    @property
    def dc(self):
        """The *current* dropless config (bucket tracks the tuner)."""
        return self._dc

    def _live(self, top_i, mc, direction):
        if direction == "forward":
            spec = self.tuner.observe(
                routed_counts(top_i, mc, self._dc.ep))
        else:
            spec = self.tuner.spec
        if spec.key() != self._dc.bucket_spec().key():
            self._dc = dataclasses.replace(self._dc, bucket=spec)
        return self._dc

    def swap_to(self, spec) -> None:
        """Force a hot swap (chaos tests; normal swaps come from refits)."""
        self.tuner.swap_to(spec, forced=True)

    def step_stats(self) -> dict:
        return self.cache.step_stats()


# ---------------------------------------------------------------------------
# Replay-driven sizing + admission control with load shedding.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Queue-depth + predicted-step-latency admission gate.

    ``slo_us`` bounds the *predicted* per-step latency
    (:func:`~repro_torch.core.autoselect.predict_plan_us` units — the gate
    and any SLO assertion must share the predictor). ``max_queue`` bounds
    deferred tokens; arrivals beyond it are shed (reported, never silently
    dropped) when ``shed`` is on, and wait unboundedly otherwise.
    """

    slo_us: float
    max_queue: int = 64
    shed: bool = True

    def __post_init__(self):
        if self.slo_us <= 0:
            raise ValueError(f"slo_us must be > 0, got {self.slo_us}")
        if self.max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {self.max_queue}")


def size_slots(counts_pop: Sequence[np.ndarray], mc, ep: int,
               slo_us: float, *, d_model: int = 64, d_ff: int = 32,
               max_slots: int = 256, cost: Optional[CostModel] = None,
               pipeline=("ratr",)) -> int:
    """Largest per-step token budget whose predicted latency fits the SLO.

    Walks batch sizes in ``ep``-token chunks, pricing the population
    profile rescaled to each size; returns the largest size still under
    ``slo_us`` (at least ``ep`` — the server must make progress). This is
    the replay-driven batch-size sizing the admission gate enforces live.
    """
    best = ep
    for n in range(ep, max_slots + 1, ep):
        plan = population_plan(counts_pop, total_rows=n * mc.top_k)
        if predict_plan_us(plan, d_model, d_ff, cost=cost,
                           pipeline=pipeline) <= slo_us:
            best = n
        else:
            break
    return best


def size_capacity_factor(counts_pop: Sequence[np.ndarray], *,
                         quantile: float = 0.99,
                         headroom: float = 1.05) -> float:
    """Capacity factor covering the population's per-expert load quantile.

    For each observed batch, each expert's load relative to the uniform
    share (``rows_e * E / total_rows``); the returned factor is the
    ``quantile`` of that distribution times ``headroom`` — the smallest
    ``MoEConfig.capacity_factor`` that would keep drop rates at
    ``1 - quantile`` under capacity-ful serving of this traffic.
    """
    loads = []
    for c in counts_pop:
        c = np.asarray(c, dtype=np.int64)
        per_e = c.sum(axis=0).reshape(-1)
        total = int(per_e.sum())
        if total:
            loads.append(per_e * (per_e.size / total))
    if not loads:
        raise ValueError("size_capacity_factor needs a non-empty population")
    return float(np.quantile(np.concatenate(loads), quantile) * headroom)


def replay_admission(trace: Sequence[np.ndarray], mc, ep: int, *,
                     d_model: int = 64, d_ff: int = 32,
                     n_slots: Optional[int] = None,
                     admission: Optional[AdmissionConfig] = None,
                     cost: Optional[CostModel] = None,
                     pipeline=("ratr",)) -> dict:
    """Token-level serving simulation of the admission gate on a trace.

    Each trace step offers a batch of routed tokens (``[T, k]`` or
    ``[ep, t_loc, k]`` top-k choices). Offered tokens enter a FIFO queue;
    per step the server admits queued tokens in ``ep``-token chunks while
    the admitted set stays within ``n_slots`` tokens *and* its actual
    routing prices under ``admission.slo_us`` (the first chunk is always
    admitted — progress guarantee). With shedding on, the residual queue
    is clamped to ``max_queue`` and the newest overflow is shed — counted,
    never silently dropped. ``admission=None`` is the unbounded baseline:
    every queued token is admitted immediately.

    Returns per-step predicted latencies and their p50/p99, ``max_active``
    (peak admitted tokens — never exceeds ``n_slots`` under a gate),
    ``shed``/``served``/``deferred`` token counts, and ``slo_miss_rate``
    when a gate is set. Deterministic; latency is predictor-priced (see
    :class:`AdmissionConfig`).
    """
    queue: list[np.ndarray] = []
    step_us: list[float] = []
    shed = served = 0
    max_active = 0
    cap = None
    if admission is not None:
        cap = n_slots if n_slots is not None else 0
        if cap <= 0:
            raise ValueError("admission control needs n_slots > 0")
        cap -= cap % ep
        cap = max(ep, cap)
        max_queue = admission.max_queue - (admission.max_queue % ep)

    def price(tokens: list[np.ndarray]) -> float:
        ti = np.stack(tokens)                      # [T, k], T % ep == 0
        plan = RoutingPlan.from_counts(routed_counts(ti, mc, ep))
        return predict_plan_us(plan, d_model, d_ff, cost=cost,
                               pipeline=pipeline)

    for top_i in trace:
        ti = np.asarray(top_i)
        queue.extend(ti.reshape(-1, ti.shape[-1]))
        if not queue:
            continue
        if admission is None:
            admit = queue
            queue = []
            us = price(admit)
        else:
            admit = queue[:ep]
            us = price(admit)
            while len(admit) + ep <= min(cap, len(queue)):
                cand = queue[:len(admit) + ep]
                cand_us = price(cand)
                if cand_us > admission.slo_us:
                    break
                admit, us = cand, cand_us
            queue = queue[len(admit):]
            if admission.shed and len(queue) > max_queue:
                shed += len(queue) - max_queue
                queue = queue[:max_queue]
        served += len(admit)
        max_active = max(max_active, len(admit))
        step_us.append(us)

    lat = np.asarray(step_us, dtype=np.float64)
    out = {
        "steps": len(step_us),
        "served": served,
        "shed": shed,
        "deferred": len(queue),
        "max_active": max_active,
        "p50_us": float(np.percentile(lat, 50)) if lat.size else 0.0,
        "p99_us": float(np.percentile(lat, 99)) if lat.size else 0.0,
    }
    if admission is not None:
        out["slo_miss_rate"] = (float((lat > admission.slo_us).mean())
                                if lat.size else 0.0)
    return out
