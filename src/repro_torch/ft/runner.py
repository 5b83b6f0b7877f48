"""Fault-tolerant training loop — counterpart of ``repro.ft.runner``.

* **checkpoint/restart** — periodic atomic checkpoints
  (``checkpoint.ckpt``); on start, auto-resume from the newest complete one
  (crash-as-restart semantics). Data order is counter-based
  (``SyntheticStream``), so a restart replays the exact batch sequence with
  no state beyond the step number.
* **straggler mitigation** — per-step wall-time watchdog with an EWMA
  baseline; steps slower than ``straggler_factor ×`` EWMA are logged. When
  the step metrics carry ``rank_time_us``, a per-rank EWMA accumulates
  alongside — the observed-time vector :meth:`RunState.cost_model`
  normalizes into ``CostModel(rank_bias=)``.
* **fault injection** — ``inject_fault(step)`` raising mid-run simulates a
  node loss; recovery loses at most ``ckpt_every - 1`` steps. Run history
  (``metrics_log``/``stragglers``) rides the checkpoint manifest, so a
  resumed run's merged log spans the crash.
* **elastic rescale** — with an :class:`ElasticContext`, live
  ``RoutingPlan``\\ s persisted in the manifest come back remapped onto the
  surviving ranks (``core.elastic.remap_plan``) and the SSC cache is
  re-keyed — not flushed — for the new mesh size.

The stream follows the port's ``sharded_batch(step, mesh, device)``
convention. The step's time ends by waiting for the loss: on the card,
``torch.cuda.synchronize``. The wall clock is read through this module's
``time``. A resume restores into the tensors of ``params`` and
``opt_state`` in place, one leaf at a time, so the state is never held
twice on the device. ``layout`` (e.g. ``convert.JaxTrainLayout``) maps the
state to the tree that is saved and restored into; without it
``(params, opt_state)`` is saved as it is.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..checkpoint import ckpt as CK
from ..core.elastic import observed_cost_model, remap_plan, surviving_ranks
from ..core.routing import RoutingPlan


@dataclasses.dataclass
class FTConfig:
    """The reference's defaults, but no default directory: a fixed one
    would make every run on a machine resume from the one before it.
    ``ckpt_dir=None`` neither saves nor resumes."""

    ckpt_dir: Optional[str]
    ckpt_every: int = 50
    keep: int = 3
    straggler_factor: float = 2.5
    ewma_alpha: float = 0.2


@dataclasses.dataclass
class ElasticContext:
    """Mesh-aware restore context: what the elastic rescale path needs.

    ``ep`` is the mesh size of *this* run. Live plans the caller registers
    in ``plans`` (name → RoutingPlan) are persisted with every checkpoint;
    on a resume whose manifest recorded a different mesh size they come
    back **remapped** onto the current mesh. ``dead_ranks`` names which
    old-mesh ranks were lost (shrink only); when ``None`` a shrink drops the
    tail ranks. ``cache`` is an ``SSCCache`` (or anything with
    ``rekey_for_mesh``) to re-key on rescale.
    """

    ep: int
    cache: Optional[object] = None
    plans: dict = dataclasses.field(default_factory=dict)
    dead_ranks: Optional[tuple] = None


@dataclasses.dataclass
class RunState:
    step: int
    params: object
    opt_state: object
    metrics_log: list
    stragglers: list
    resumed_from: Optional[int] = None
    # Per-rank step-time EWMA (None until a step reports "rank_time_us").
    rank_time_ewma: Optional[list] = None
    # One record per rescale the restore path performed.
    elastic_events: list = dataclasses.field(default_factory=list)
    # One record per checkpoint restored or saved: op, step, host-clock
    # seconds (the layout's conversion and the host copy included) and the
    # step directory's bytes on disk.
    ckpt_log: list = dataclasses.field(default_factory=list)

    def cost_model(self, base=None):
        """Observed-time-biased CostModel (``base`` or the default while no
        rank has reported a time)."""
        return observed_cost_model(self.rank_time_ewma, base)


def _run_extra(elastic: Optional[ElasticContext], metrics_log: list,
               stragglers: list, rank_ewma: Optional[list]) -> dict:
    """JSON-safe manifest ``extra``: run history + the elastic plan world."""
    extra: dict = {
        "metrics_log": metrics_log,
        "stragglers": [list(s) for s in stragglers],
    }
    if rank_ewma is not None:
        extra["rank_time_ewma"] = [float(x) for x in rank_ewma]
    if elastic is not None:
        extra["ep"] = elastic.ep
        extra["plans"] = {
            name: np.asarray(p.counts, dtype=np.int64).tolist()
            for name, p in elastic.plans.items()}
    return extra


def _elastic_restore(elastic: ElasticContext, prev_ep: int, extra: dict,
                     rank_ewma: Optional[list], start_step: int,
                     events: list) -> Optional[list]:
    """Remap the persisted plan world from ``prev_ep`` onto ``elastic.ep``.

    Mutates ``elastic.plans`` in place, re-keys ``elastic.cache``, and
    returns the survivor-restricted per-rank EWMA vector.
    """
    if elastic.ep < prev_ep:
        dead = (tuple(int(r) for r in elastic.dead_ranks)
                if elastic.dead_ranks is not None
                else tuple(range(elastic.ep, prev_ep)))
        survivors = surviving_ranks(prev_ep, dead)
        if len(survivors) != elastic.ep:
            raise ValueError(
                f"dead_ranks={dead} leaves {len(survivors)} survivors of "
                f"the checkpoint's {prev_ep}-rank mesh, but this run has "
                f"ep={elastic.ep}")
        kw = {"dead_ranks": dead}
    else:
        survivors = tuple(range(prev_ep))
        kw = {"new_ep": elastic.ep}

    for name, counts in (extra.get("plans") or {}).items():
        old = RoutingPlan.from_counts(np.asarray(counts, dtype=np.int64))
        elastic.plans[name] = remap_plan(old, **kw)

    if rank_ewma is not None and len(rank_ewma) == prev_ep:
        kept = [float(rank_ewma[r]) for r in survivors]
        # Re-admitted ranks start at the survivors' mean — unbiased until
        # they report their own times.
        fill = float(np.mean(kept)) if kept else 0.0
        rank_ewma = kept + [fill] * (elastic.ep - len(kept))

    rekey = None
    if elastic.cache is not None:
        rekey = elastic.cache.rekey_for_mesh(elastic.ep)
    events.append({"step": start_step, "from_ep": prev_ep,
                   "to_ep": elastic.ep, "survivors": list(survivors),
                   "plans": sorted(elastic.plans), "cache": rekey})
    return rank_ewma


def _wait(loss) -> None:
    if isinstance(loss, torch.Tensor) and loss.is_cuda:
        torch.cuda.synchronize(loss.device)


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def train_loop(*, step_fn, params, opt_state, stream, mesh, device,
               n_steps: int, ft: FTConfig,
               inject_fault: Optional[Callable[[int], None]] = None,
               log_every: int = 10,
               elastic: Optional[ElasticContext] = None,
               layout=None,
               on_step: Optional[Callable[[int, dict, float],
                                          Optional[dict]]] = None
               ) -> RunState:
    """Run (or resume) ``n_steps`` of training with FT behaviours.

    ``on_step(step, metrics, seconds)`` runs after every step (``step``
    before the increment); the JSON-safe dict it returns joins the step's
    log record, and so rides the checkpoint with it."""
    start_step = 0
    resumed_from = None
    metrics_log: list = []
    stragglers: list = []
    rank_ewma: Optional[list] = None
    elastic_events: list = []
    ckpt_log: list = []
    saving = ft.ckpt_dir is not None
    latest = CK.latest_step_dir(ft.ckpt_dir) if saving else None
    if latest is not None:
        t0 = time.time()
        if layout is None:
            (params, opt_state), manifest = CK.restore(
                latest, (params, opt_state), into=True)
        else:
            manifest = layout.restore(latest, params, opt_state)
        start_step = manifest["step"]
        ckpt_log.append({"op": "restore", "step": start_step,
                         "s": time.time() - t0, "bytes": _dir_bytes(latest)})
        resumed_from = start_step
        extra = manifest.get("extra") or {}
        # Merged run history: pre-crash entries come back from the manifest
        # (logged with the post-increment step, so <= the checkpoint's).
        metrics_log = [m for m in extra.get("metrics_log", [])
                       if m.get("step", 0) <= start_step]
        stragglers = [tuple(s) for s in extra.get("stragglers", [])]
        rank_ewma = extra.get("rank_time_ewma")
        prev_ep = extra.get("ep")
        if elastic is not None and prev_ep and prev_ep != elastic.ep:
            rank_ewma = _elastic_restore(elastic, prev_ep, extra, rank_ewma,
                                         start_step, elastic_events)

    ewma = None
    step = start_step
    while step < n_steps:
        if inject_fault is not None:
            inject_fault(step)  # may raise — simulating a node loss
        batch = stream.sharded_batch(step, mesh, device)
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        _wait(metrics["loss"])
        dt = time.time() - t0

        if ewma is None:
            ewma = dt
        elif dt > ft.straggler_factor * ewma:
            stragglers.append((step, dt, ewma))
        ewma = (1 - ft.ewma_alpha) * ewma + ft.ewma_alpha * dt

        rt = metrics.get("rank_time_us")
        if rt is not None:
            rt = [float(x) for x in np.ravel(np.asarray(rt))]
            if rank_ewma is None or len(rank_ewma) != len(rt):
                rank_ewma = rt
            else:
                a = ft.ewma_alpha
                rank_ewma = [(1 - a) * e + a * x
                             for e, x in zip(rank_ewma, rt)]

        more = on_step(step, metrics, dt) if on_step is not None else None
        step += 1
        if step % log_every == 0 or step == n_steps:
            metrics_log.append(
                {"step": step,
                 "loss": float(metrics["loss"]),
                 "grad_norm": float(metrics["grad_norm"]),
                 "step_time_s": dt, **(more or {})})
        if saving and (step % ft.ckpt_every == 0 or step == n_steps):
            t0 = time.time()
            tree = ((params, opt_state) if layout is None
                    else layout.tree(params, opt_state))
            path = CK.save(ft.ckpt_dir, step, tree,
                           extra=_run_extra(elastic, metrics_log, stragglers,
                                            rank_ewma))
            ckpt_log.append({"op": "save", "step": step,
                             "s": time.time() - t0,
                             "bytes": _dir_bytes(path)})
            CK.gc_old(ft.ckpt_dir, keep=ft.keep)

    return RunState(step=step, params=params, opt_state=opt_state,
                    metrics_log=metrics_log, stragglers=stragglers,
                    resumed_from=resumed_from, rank_time_ewma=rank_ewma,
                    elastic_events=elastic_events, ckpt_log=ckpt_log)
