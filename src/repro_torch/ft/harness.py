"""Deterministic fault-injection harness for the elastic FT stack — the
port's twin of the reference's ``tests/ftharness.py``.

Drives a tiny dropless MoE training loop through the three failure modes
production clusters see, and reports machine-checkable invariants for each:

* **kill** — the run dies at step *k* and resumes from the newest complete
  checkpoint: recovery loses at most ``ckpt_every - 1`` steps,
  ``resumed_from`` is exact, and the merged post-resume loss trajectory is
  *bit-identical* to a never-failed run.
* **slow** — one rank reports 3× step times; the per-rank EWMA the loop
  accumulates feeds ``CostModel(rank_bias=)``: the slow rank becomes the
  compile-time critical rank and ``autoselect`` picks a pipeline containing
  ``critical_rank_first``.
* **rescale** — the run dies, then resumes on a mesh shrunk by one rank:
  persisted live plans come back remapped cell-identical to plans built
  natively on the small mesh, the shared ``SSCCache`` shows re-keyed (never
  evicted) entries, and the rescaled dropless impl's outputs are
  bit-identical to a fresh native small-mesh impl's.

Every scenario runs under two routing profiles: ``uniform`` (the raw
router) and ``hotspot`` (router biased so expert 0 dominates). The fixture
scale, the data (``rank_shard``) and the check names are the reference's;
the dropless impl is ``DroplessMoE(DroplessConfig(ep=..., bucket=4))``, and
everything runs on ``device`` — by default the card, where the fragment's
GMM tiles launch the ``gmm`` kernel:

    PYTHONPATH=src python -m repro_torch.ft.harness \\
        --kinds kill,slow,rescale --profiles uniform,hotspot [--device cpu]

One JSON line per (kind, profile) cell; exit 1 if any check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from ..core import autoselect
from ..core.elastic import check_remap, surviving_ranks
from ..core.odg import ScheduleConfig
from ..core.routing import balanced_plan
from ..core.ssc import SSCCache
from ..device import resolve_device
from ..launch.dropless import DroplessConfig, DroplessMoE
from ..models.moe import MoEConfig, init_moe, plan_from_routing, router_topk
from ..optim.adamw import tree_leaves
from .runner import ElasticContext, FTConfig, train_loop

# Fixture scale: e_total = 6 divides both the 3-rank mesh (e_loc = 2) and
# the post-loss 2-rank mesh (e_loc = 3), so a one-rank shrink is legal.
D_MODEL = 8
T_LOC = 8
EP = 3
MC = MoEConfig(n_experts=6, top_k=2, d_expert=4)

PROFILES = ("uniform", "hotspot")
KINDS = ("kill", "slow", "rescale")


def make_params(profile: str, seed: int = 0, device="cuda") -> dict:
    dev = resolve_device(device)
    params = init_moe(torch.Generator(device=dev).manual_seed(seed),
                      D_MODEL, MC)
    if profile == "hotspot":
        # Bias the router so expert 0 wins every token's top-1 slot — the
        # concentrated (rank 0, expert 0) profile.
        params["router"][:, 0] += 4.0
    elif profile != "uniform":
        raise ValueError(f"unknown profile {profile!r}; choices: {PROFILES}")
    return params


def rank_shard(rank: int, step: int) -> np.ndarray:
    """Rank ``rank``'s tokens for ``step`` — a pure function of (rank,
    step), so a surviving rank's data is unchanged by who else is alive."""
    rng = np.random.default_rng([1234, rank, step])
    return rng.standard_normal((T_LOC, D_MODEL)).astype(np.float32)


class ShardStream:
    """Counter-based stream that concatenates the live ranks' shards."""

    def __init__(self, ranks):
        self.ranks = tuple(int(r) for r in ranks)

    def sharded_batch(self, step, mesh, device):
        x = np.concatenate([rank_shard(r, step) for r in self.ranks])
        return {"x": torch.as_tensor(x, device=device)}


def make_dm(ep: int = EP, cache: SSCCache = None) -> DroplessMoE:
    return DroplessMoE(DroplessConfig(ep=ep, bucket=4),
                       cache=cache if cache is not None else SSCCache(64))


def make_step(dm: DroplessMoE, slow_rank: int = None,
              slow_factor: float = 1.0, lr: float = 0.05):
    """SGD step through the dropless impl — bitwise deterministic, with a
    fabricated per-rank timing vector (the watchdog input a real cluster
    measures; fabrication keeps the slow-rank scenario deterministic)."""

    def step(params, opt_state, batch):
        x = batch["x"][None]                         # [1, T, d]
        names = sorted(params)
        p = {k: params[k].detach().requires_grad_(True) for k in names}
        y = dm.impl(p, x, MC)
        loss = torch.mean(y * y)
        grads = torch.autograd.grad(loss, [p[k] for k in names])
        params2 = {k: (params[k] - lr * g).detach()
                   for k, g in zip(names, grads)}
        gn = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        rank_t = np.full(dm.dc.ep, 100.0)
        if slow_rank is not None and 0 <= slow_rank < dm.dc.ep:
            rank_t[slow_rank] *= slow_factor
        return params2, opt_state, {"loss": loss.detach(), "grad_norm": gn,
                                    "rank_time_us": rank_t}

    return step


def _loop(dm, params, stream, ckpt_dir, n_steps, device, *, ckpt_every=3,
          inject_fault=None, elastic=None, slow_rank=None, slow_factor=1.0):
    return train_loop(
        step_fn=make_step(dm, slow_rank=slow_rank, slow_factor=slow_factor),
        params=params, opt_state=None, stream=stream, mesh=None,
        device=resolve_device(device), n_steps=n_steps,
        ft=FTConfig(ckpt_dir=ckpt_dir, ckpt_every=ckpt_every),
        inject_fault=inject_fault, log_every=1, elastic=elastic)


def _bomb_at(k: int):
    armed = {"on": True}

    def bomb(step):
        if step == k and armed["on"]:
            armed["on"] = False
            raise RuntimeError(f"injected kill at step {k}")

    return bomb


def _trajectory(run) -> list:
    return [(m["step"], m["loss"], m["grad_norm"]) for m in run.metrics_log]


# ---------------------------------------------------------------------------
# Scenarios. Each returns {check_name: bool}; all true = pass.
# ---------------------------------------------------------------------------

def run_kill(profile: str, tmp: str, k: int = 4, ckpt_every: int = 3,
             n_steps: int = 6, device="cuda") -> dict:
    """Kill at step ``k``, resume, compare against a never-failed twin."""
    stream = ShardStream(range(EP))
    base = _loop(make_dm(), make_params(profile, device=device), stream,
                 os.path.join(tmp, "base"), n_steps, device,
                 ckpt_every=ckpt_every)

    crash_dir = os.path.join(tmp, "crash")
    try:
        _loop(make_dm(), make_params(profile, device=device), stream,
              crash_dir, n_steps, device, ckpt_every=ckpt_every,
              inject_fault=_bomb_at(k))
        crashed = False
    except RuntimeError:
        crashed = True
    run = _loop(make_dm(), make_params(profile, device=device), stream,
                crash_dir, n_steps, device, ckpt_every=ckpt_every)

    expect_resume = (k // ckpt_every) * ckpt_every if k >= ckpt_every \
        else None
    lost = k - (expect_resume or 0)
    return {
        "crashed": crashed,
        "resumed_from_correct": run.resumed_from == expect_resume,
        "bounded_loss_of_work": 0 <= lost <= ckpt_every - 1,
        "log_spans_crash": [m["step"] for m in run.metrics_log]
        == list(range(1, n_steps + 1)),
        "trajectory_bit_identical": _trajectory(run) == _trajectory(base),
        "params_bit_identical": all(
            torch.equal(a, b) for a, b in
            zip(tree_leaves(base.params), tree_leaves(run.params))),
    }


def run_slow(profile: str, tmp: str, slow_rank: int = 2,
             factor: float = 3.0, n_steps: int = 4, device="cuda") -> dict:
    """A 3× slow rank becomes the compile-time critical rank."""
    run = _loop(make_dm(), make_params(profile, device=device),
                ShardStream(range(EP)), os.path.join(tmp, "slow"), n_steps,
                device, ckpt_every=10, slow_rank=slow_rank,
                slow_factor=factor)
    cm = run.cost_model()
    plan = balanced_plan(EP, MC.e_total // EP, T_LOC)
    cfg = ScheduleConfig(ep=EP, e_loc=MC.e_total // EP, rows=T_LOC,
                         d_model=D_MODEL, d_ff=MC.d_expert, plan=plan)
    ratio, crit = cm.critical_rank(
        autoselect.cube_taskset(plan, cfg, "forward"))
    choice = autoselect.select(plan, cfg, cm)
    names = [n for n, _ in choice.pipeline.key()]
    return {
        "bias_recorded": cm.rank_bias is not None
        and len(cm.rank_bias) == EP,
        "slow_rank_max_bias": cm.rank_bias is not None
        and max(range(EP), key=lambda r: cm.rank_bias[r]) == slow_rank,
        "critical_rank_is_slow_rank": crit == slow_rank,
        "straggler_fires": ratio > 1.05,
        "autoselect_picks_crit": "critical_rank_first" in names,
    }


def run_rescale(profile: str, tmp: str, dead=(2,), k: int = 4,
                ckpt_every: int = 2, n_steps: int = 8,
                device="cuda") -> dict:
    """Kill mid-run, resume on a mesh shrunk by one rank."""
    dev = resolve_device(device)
    cache = SSCCache(64)
    dm = make_dm(EP, cache)
    params = make_params(profile, device=dev)

    # The live plan the big-mesh run registers (step-0 routing).
    x0 = np.concatenate([rank_shard(r, 0) for r in range(EP)])
    ti0 = router_topk(params["router"], torch.as_tensor(x0, device=dev),
                      MC)[1].cpu().numpy()
    ti0 = ti0.reshape(EP, T_LOC, MC.top_k)
    live_plan = plan_from_routing(ti0, MC, EP, capacity=None).plan

    ckpt_dir = os.path.join(tmp, "rescale")
    try:
        _loop(dm, params, ShardStream(range(EP)), ckpt_dir, n_steps, dev,
              ckpt_every=ckpt_every, inject_fault=_bomb_at(k),
              elastic=ElasticContext(ep=EP, cache=cache,
                                     plans={"step0": live_plan}))
        crashed = False
    except RuntimeError:
        crashed = True

    survivors = surviving_ranks(EP, dead)
    new_ep = len(survivors)
    dm2 = dm.rescale(dead_ranks=dead)            # shares + re-keys the cache
    elastic = ElasticContext(ep=new_ep, cache=cache, dead_ranks=tuple(dead))
    run = _loop(dm2, make_params(profile, device=dev), ShardStream(survivors),
                ckpt_dir, n_steps, dev, ckpt_every=ckpt_every,
                elastic=elastic)

    # Remapped plan vs the plan built natively on the small mesh from the
    # survivors' own token→expert assignments.
    remapped = elastic.plans.get("step0")
    native = plan_from_routing(ti0[list(survivors)], MC, new_ep,
                               capacity=None).plan
    # Rescaled impl vs a fresh native small-mesh impl, same inputs: the
    # executor is per-row deterministic, so outputs must be bit-identical.
    x_small = torch.as_tensor(np.concatenate(
        [rank_shard(r, 0) for r in survivors])[None], device=dev)
    with torch.no_grad():
        y_rescaled = dm2.impl(run.params, x_small, MC)
        y_native = make_dm(new_ep).impl(run.params, x_small, MC)
    info = cache.info()

    expect_resume = (k // ckpt_every) * ckpt_every if k >= ckpt_every \
        else None
    return {
        "crashed": crashed,
        "resumed_from_correct": run.resumed_from == expect_resume,
        "rescale_event_recorded": len(run.elastic_events) == 1
        and run.elastic_events[0]["from_ep"] == EP
        and run.elastic_events[0]["to_ep"] == new_ep,
        "plan_remapped": remapped is not None
        and remapped.ep == new_ep,
        "remap_matches_native_plan": remapped is not None
        and remapped.counts == native.counts,
        "remap_invariants": remapped is not None
        and check_remap(live_plan, remapped, survivors)["ok"],
        "impl_bit_identical_to_native": torch.equal(y_rescaled, y_native),
        "cache_rekeyed_not_flushed": info["rekeyed"] >= 1
        and info["active_ep"] == new_ep and info["evictions"] == 0
        and info["by_ep"].get(EP, 0) > 0 and info["by_ep"].get(new_ep, 0) > 0,
        "run_completed": run.step == n_steps,
    }


_SCENARIOS = {"kill": run_kill, "slow": run_slow, "rescale": run_rescale}


def run_scenario(kind: str, profile: str, tmp: str, device="cuda") -> dict:
    return _SCENARIOS[kind](profile, tmp, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kinds", default=",".join(KINDS),
                    help=f"comma-separated scenario kinds ({','.join(KINDS)})")
    ap.add_argument("--profiles", default=",".join(PROFILES),
                    help="comma-separated routing profiles "
                         f"({','.join(PROFILES)})")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    kinds = [k.strip() for k in args.kinds.split(",") if k.strip()]
    profiles = [p.strip() for p in args.profiles.split(",") if p.strip()]
    unknown = [k for k in kinds if k not in _SCENARIOS]
    if unknown:
        ap.error(f"unknown kinds {unknown}; choices: {sorted(_SCENARIOS)}")

    failures = 0
    with tempfile.TemporaryDirectory() as td:
        for kind in kinds:
            for profile in profiles:
                checks = run_scenario(
                    kind, profile, os.path.join(td, f"{kind}_{profile}"),
                    device=args.device)
                ok = all(bool(v) for v in checks.values())
                failures += not ok
                print(json.dumps({"scenario": kind, "profile": profile,
                                  "ok": ok, "checks": checks}), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
