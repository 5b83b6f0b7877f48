"""Quickstart: the three layers of HyperParallel-MoE in the port —
counterpart of ``examples/quickstart.py``.

1. Compile a MoE-FFN fragment into a static CTQ/VTQ taskflow (SSC).
2. Validate the schedule numerically against the monolithic reference, on
   the device, and compare the simulated makespans (the Ascend A3 model's
   predictions, not times of any device); then compile dropless schedules
   from real router output through the plan-keyed cache.
3. Train a tiny MoE model a few steps; on the card its expert FFN runs the
   GMM kernels (the model's normal MoE path).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
      PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import get_smoke_config
from ..core import executor as ex
from ..core.odg import ScheduleConfig, build_moe_ffn_forward
from ..core.scheduler import compile_schedule
from ..core.simulator import simulate_baseline, simulate_unified
from ..core.ssc import SSCCache
from ..data.pipeline import DataConfig, SyntheticStream
from ..device import resolve_device
from ..launch.steps import make_train_step
from ..models import model as M
from ..models.moe import MoEConfig, init_moe, plan_from_routing, router_topk
from ..optim import adamw

# Step 1's fragment and the plain run's baseline (one GMM tile a rank).
SCHED = dict(ep=4, e_loc=4, rows=64, d_model=512, d_ff=256)
M_SPLIT = 8
# Step 2b: router output of jittered batches, bucketed into one cache entry.
DROPLESS_MC = MoEConfig(n_experts=8, top_k=2, d_expert=16)
DROPLESS_EP, DROPLESS_D, DROPLESS_T, BUCKET = 4, 64, 128, "linear:32"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=20,
                    help="training steps of step 3")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {"device": str(dev)}

    # --- 1. compile a schedule ------------------------------------------
    cfg = ScheduleConfig(**SCHED, gmm_m_split=M_SPLIT)
    sched = compile_schedule(build_moe_ffn_forward(cfg), pipeline=["ratr"])
    out.update(tasks=sched.n_tasks, events=len(sched.events),
               ctq0=len(sched.queue(0, "CTQ")),
               vtq0=len(sched.queue(0, "VTQ")))
    print(f"compiled taskflow: {out['tasks']} tile tasks, "
          f"{out['events']} events, CTQ[0]={out['ctq0']} "
          f"VTQ[0]={out['vtq0']}")

    # --- 2. numerical validation + simulated speedup ---------------------
    x_src, w1, w2 = ex.make_inputs(cfg, device=dev)
    st = ex.ExecutorState(cfg, device=dev)
    ex.load_forward_state(cfg, st, x_src, w1, w2)
    ex.execute(sched, st, rng=np.random.default_rng(0))
    ref = ex.reference_forward(cfg, x_src, w1, w2)
    got = torch.stack([st.get("y_ret", r) for r in range(cfg.ep)])
    torch.testing.assert_close(got, ref["y_ret"], rtol=1e-5, atol=1e-5)
    out["executor_max_abs_err"] = float((got - ref["y_ret"]).abs().max())
    print("executor == monolithic reference ✓")

    base = simulate_baseline(compile_schedule(build_moe_ffn_forward(
        ScheduleConfig(**SCHED))))
    uni = simulate_unified(sched)
    out.update(base_us=base.makespan_us, unified_us=uni.makespan_us)
    print(f"simulated D2C (Ascend A3 model): baseline {base.makespan_us:.0f}us"
          f" → unified {uni.makespan_us:.0f}us "
          f"({base.makespan_us / uni.makespan_us:.2f}x)")

    # --- 2b. dropless: compile from real router output, reuse via buckets
    gen = torch.Generator(device=dev).manual_seed(2)
    moe_params = init_moe(gen, DROPLESS_D, DROPLESS_MC)
    cache = SSCCache(max_entries=16)
    out["top_i"] = []
    for _ in range(3):
        xb = torch.randn((DROPLESS_T, DROPLESS_D), generator=gen, device=dev)
        _, top_i = router_topk(moe_params["router"], xb, DROPLESS_MC)
        top_i = top_i.cpu().numpy()
        out["top_i"].append(top_i)
        # capacity=None → dropless; the bucket quantizes the plan so that
        # jittered batches share one SSC cache entry.
        bridge = plan_from_routing(top_i, DROPLESS_MC, DROPLESS_EP,
                                   capacity=None, bucket=BUCKET)
        cfg_d = ScheduleConfig(ep=DROPLESS_EP,
                               e_loc=DROPLESS_MC.n_experts // DROPLESS_EP,
                               rows=0, d_model=DROPLESS_D,
                               d_ff=DROPLESS_MC.d_expert, plan=bridge.plan)
        cache.get_or_compile(cfg_d, "forward", pipeline=["ratr"])
    out["cache"] = cache.info()
    print(f"dropless cache after 3 jittered batches: {out['cache']}")

    # --- 3. train a tiny MoE model ---------------------------------------
    mcfg = get_smoke_config("granite-moe-3b-a800m")
    params = adamw.cast_params(M.init_params(
        mcfg, torch.Generator(device=dev).manual_seed(0), device=dev),
        mcfg.compute_dtype)
    opt_state = adamw.init_opt_state(params)
    step = make_train_step(mcfg, adamw.OptConfig(
        lr=3e-3, warmup_steps=5, total_steps=50, weight_decay=0.0))
    stream = SyntheticStream(DataConfig(vocab=mcfg.vocab, seq_len=32,
                                        global_batch=8))
    out["losses"] = []
    for i in range(args.steps):
        params, opt_state, m = step(params, opt_state, stream.batch(i, dev))
        out["losses"].append(float(m["loss"]))
        if i % 5 == 0:
            print(f"step {i:3d} loss {out['losses'][-1]:.4f}")
    if not all(np.isfinite(out["losses"])):
        raise RuntimeError(f"non-finite training loss: {out['losses']}")
    print("quickstart complete.")
    return out


if __name__ == "__main__":
    main()
