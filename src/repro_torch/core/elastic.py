"""Elastic plan remapping — the compiled-schedule stack under rank loss; a
copy of ``repro.core.elastic`` (its remapped plans, reports and biases
equal the reference's, and it raises the same exceptions on the same
inputs). :func:`rechunk_expert_array` also re-chunks torch tensors.

The statically scheduled taskflows assume a fixed EP group, but production
MoE training is defined by rank loss and rescale (Pangu Ultra MoE and the
TeleChat3-MoE training reports both treat fault recovery as first-order).
This module makes the *plan world* participate in the FT story (the
reference's runner, ``repro.ft.runner``, is not ported): when the mesh
changes, live
:class:`~repro_torch.core.routing.RoutingPlan`\\ s are **remapped** onto the
surviving ranks instead of thrown away, the ``SSCCache`` is **re-keyed**
(never flushed — see ``repro_torch.core.ssc.SSCCache.rekey_for_mesh``), and
observed per-rank step times feed back into
``CostModel(rank_bias=)`` so a persistently slow rank becomes the
compile-time critical rank ``critical_rank_first`` / ``autoselect`` already
know how to schedule around.

Remap semantics (what makes the bit-for-bit guarantee possible)
---------------------------------------------------------------

``remap_plan(plan, dead_ranks=...)`` shrinks an ``[ep, ep, e_loc]`` plan
onto the ``S`` survivors:

* **sources** — a dead rank's data shard is gone for the step, so its rows
  are dropped; every surviving source keeps its rows exactly (*row
  conservation*: ``new.send_rows(i) == old.send_rows(survivors[i])``).
* **experts** — experts are identified by their *global* index
  ``g = dst * e_loc + e`` and re-chunked contiguously over the survivors
  (``e_loc' = ep * e_loc / S``, requires divisibility):
  ``new[s'][d'][e'] = old[survivors[s']][g // e_loc][g % e_loc]`` with
  ``g = d' * e_loc' + e'``. This preserves global expert order, which is
  exactly how expert weights re-chunk under a pure reshape
  (:func:`rechunk_expert_array`) and exactly what
  ``models.moe.plan_from_routing`` produces on the shrunken mesh for the
  same token→expert assignment — so a remapped plan equals a plan built
  natively on the small mesh, cell for cell.
* **send-buffer invariance** — a source's send buffer is (dst, expert)-
  destination-major, i.e. ordered by ascending global expert ``g``; the
  re-chunk preserves that order, so a surviving source's send buffer (and
  therefore every per-row executor output) is *bit-identical* across the
  remap. Offset validity and the single-trigger tiling invariants hold
  because the result is an ordinary ``RoutingPlan`` (offsets are derived,
  ``source_aligned`` tiling is legal for arbitrary plans).

Growth (``new_ep > ep``) is supported symmetrically: re-admitted ranks
join as zero-row sources and the expert axis re-chunks finer.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from .costmodel import CostModel
from .routing import RoutingPlan

# Observed-time bias is clipped to this band: a wedged rank's 100x blowup
# should mark it critical, not blow up every priced candidate.
BIAS_FLOOR = 0.25
BIAS_CEIL = 8.0


def surviving_ranks(ep: int, dead_ranks: Iterable[int]) -> tuple[int, ...]:
    """Sorted ranks of the old mesh that survive ``dead_ranks``."""
    dead = {int(r) for r in dead_ranks}
    bad = [r for r in dead if r < 0 or r >= ep]
    if bad:
        raise ValueError(f"dead ranks {sorted(bad)} outside mesh of {ep}")
    survivors = tuple(r for r in range(ep) if r not in dead)
    if not survivors:
        raise ValueError(f"all {ep} ranks dead — nothing to remap onto")
    return survivors


def remap_plan(plan: RoutingPlan, dead_ranks: Optional[Iterable[int]] = None,
               new_ep: Optional[int] = None) -> RoutingPlan:
    """Redistribute a live plan's cells onto the surviving mesh.

    Exactly one of ``dead_ranks`` (explicit rank loss; survivors keep their
    old order) or ``new_ep`` (rescale; shrink = tail ranks dead, grow =
    fresh zero-row sources appended) must be given. Experts of lost ranks
    are reassigned deterministically by re-chunking the global expert axis
    over the survivors — see the module docstring for the invariants.

    Raises ``ValueError`` when the total expert count does not divide over
    the new mesh size.
    """
    if (dead_ranks is None) == (new_ep is None):
        raise ValueError("pass exactly one of dead_ranks= or new_ep=")
    ep, e_loc = plan.ep, plan.e_loc
    e_total = ep * e_loc
    if dead_ranks is not None:
        survivors = surviving_ranks(ep, dead_ranks)
        s_new = len(survivors)
    else:
        s_new = int(new_ep)
        if s_new < 1:
            raise ValueError(f"new_ep must be >= 1, got {new_ep}")
        survivors = tuple(range(min(s_new, ep)))
    if e_total % s_new:
        ok = [s for s in range(1, e_total + 1) if e_total % s == 0]
        raise ValueError(
            f"cannot remap {e_total} experts onto {s_new} ranks "
            f"(not divisible); valid mesh sizes: {ok}")
    e_loc2 = e_total // s_new

    c = np.asarray(plan.counts, dtype=np.int64)
    # (dst, e) flattens to the global expert axis in ascending-g order —
    # the same order the send buffer lays rows out in, so surviving
    # sources' buffers are bit-identical after the re-chunk below.
    flat = c.reshape(ep, e_total)[list(survivors)]
    if len(survivors) < s_new:                      # growth: empty sources
        pad = np.zeros((s_new - len(survivors), e_total), dtype=np.int64)
        flat = np.concatenate([flat, pad], axis=0)
    return RoutingPlan.from_counts(flat.reshape(s_new, s_new, e_loc2))


def rechunk_expert_array(arr, new_ep: int, e_total: Optional[int] = None):
    """Re-chunk an expert-major array onto a new mesh size.

    ``arr`` is either logical ``[e_total, ...]`` or per-rank
    ``[ep, e_loc, ...]`` (pass ``e_total=`` to disambiguate when both
    divide); the result is ``[new_ep, e_total // new_ep, ...]`` with global
    expert order preserved — the weight-side twin of :func:`remap_plan`'s
    expert re-chunk, a pure reshape (no copy of expert contents, so
    remapped weights are bit-identical per expert). A torch tensor comes
    back as a tensor (a view where the reshape allows one), anything else
    as a numpy array.
    """
    a = arr if isinstance(arr, torch.Tensor) else np.asarray(arr)
    if e_total is not None:
        if a.shape[0] != e_total:
            a = a.reshape(e_total, *a.shape[2:])
    # Per-rank [ep, e_loc, ...] is resolved first — when dim 0 is a mesh
    # size it generally does not divide by new_ep, while [ep * e_loc] does.
    elif a.ndim >= 2 and a.shape[0] % new_ep != 0 \
            and (a.shape[0] * a.shape[1]) % new_ep == 0:
        a = a.reshape(a.shape[0] * a.shape[1], *a.shape[2:])
    flat = a
    if flat.shape[0] % new_ep:
        raise ValueError(
            f"{flat.shape[0]} experts cannot re-chunk onto {new_ep} ranks")
    e_total = flat.shape[0]
    return flat.reshape(new_ep, e_total // new_ep, *flat.shape[1:])


def check_remap(old: RoutingPlan, new: RoutingPlan,
                survivors: Sequence[int]) -> dict:
    """Invariant report for one remap (tests and the fault harness).

    Keys are booleans: ``row_conservation`` (surviving sources keep their
    totals), ``cells_preserved`` (per-(source, global expert) counts
    unchanged), ``offsets_valid`` (send/recv offset tables consistent with
    the counts), ``no_dead_cells`` (total rows equals the survivors' rows —
    nothing is addressed outside the new mesh by construction of the
    ``[S, S, e_loc']`` shape).
    """
    survivors = list(survivors)
    oc = np.asarray(old.counts, dtype=np.int64)
    nc = np.asarray(new.counts, dtype=np.int64)
    e_total = old.ep * old.e_loc
    old_flat = oc.reshape(old.ep, e_total)[survivors]
    new_flat = nc.reshape(new.ep, new.ep * new.e_loc)[:len(survivors)]
    report = {
        "row_conservation": all(
            new.send_rows(i) == old.send_rows(r)
            for i, r in enumerate(survivors)),
        "cells_preserved": bool((old_flat == new_flat).all()),
        "no_dead_cells": int(nc.sum()) == int(old_flat.sum()),
        "offsets_valid": _offsets_valid(new),
    }
    report["ok"] = all(report.values())
    return report


def _offsets_valid(plan: RoutingPlan) -> bool:
    """Send/recv offset tables are monotone prefix sums of the counts."""
    c = np.asarray(plan.counts, dtype=np.int64)
    for s in range(plan.ep):
        run = 0
        for d in range(plan.ep):
            for e in range(plan.e_loc):
                if plan.send_offset(s, d, e) != run:
                    return False
                run += int(c[s, d, e])
        if run != plan.send_rows(s):
            return False
    for d in range(plan.ep):
        run = 0
        for e in range(plan.e_loc):
            if plan.expert_offset(d, e) != run:
                return False
            for s in range(plan.ep):
                if plan.recv_offset(d, e, s) != run:
                    return False
                run += int(c[s, d, e])
        if run != plan.recv_rows(d):
            return False
    return True


# ---------------------------------------------------------------------------
# Observed-time feedback: straggler wall times → compile-time cost bias.
# ---------------------------------------------------------------------------

def rank_bias_from_times(times, floor: float = BIAS_FLOOR,
                         ceil: float = BIAS_CEIL) -> tuple[float, ...]:
    """Mean-normalized per-rank slowdown factors from observed step times.

    ``times`` is any per-rank sequence of observed wall times (the
    reference's runner feeds it an EWMA of ``rank_time_us`` step
    metrics). The result is clipped to ``[floor, ceil]`` and normalized to
    mean 1.0 *before* clipping, so a healthy mesh prices exactly as an
    unbiased model while a wedged rank cannot blow up every candidate.
    """
    t = np.asarray(list(times), dtype=np.float64)
    if t.size == 0:
        raise ValueError("rank_bias_from_times: empty time vector")
    if (t < 0).any():
        raise ValueError(f"negative observed times: {t.tolist()}")
    mean = t.mean()
    if mean <= 0:
        return tuple(1.0 for _ in range(t.size))
    bias = np.clip(t / mean, floor, ceil)
    return tuple(float(b) for b in bias)


def observed_cost_model(rank_times, base: Optional[CostModel] = None,
                        ) -> CostModel:
    """A :class:`CostModel` biased by observed per-rank step times.

    ``rank_times`` of None (no feedback yet) returns ``base`` unchanged.
    The biased model stays frozen/hashable, so it flows through the
    memoized ``autoselect`` selector — a persistently slow rank becomes the
    compile-time critical rank and ``critical_rank_first`` fires for it.
    """
    import dataclasses
    base = base if base is not None else CostModel(l2=False)
    if rank_times is None:
        return base
    return dataclasses.replace(base,
                               rank_bias=rank_bias_from_times(rank_times))
