"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device — the card's name and power limit (``nvidia-smi``);
2. build — both CUDA kernels compiled for ``sm_90a`` from ``src/repro_torch``;
3. kernel checks — each kernel against its plain PyTorch version on the card,
   at the serving path's shapes (granite-moe-3b-a800m: 48 experts, C = 1 and
   2 in decode, 27 in a 128-token prefill) and at ragged test shapes, in
   bf16 and fp32, with CUDA-event times beside the plain version's, the
   ``torch.bmm`` yardstick's and the bytes/operations bound;
4. slice — full-width, 32-layer granite-moe-3b-a800m in bf16 with random
   weights from a seed: one prefill through the kernels against the plain
   expert FFN, then ``launch.serve.serve`` answers 16 requests of 128-token
   prompts with 8 slots and 32 new tokens each. Both kernels' launch counts
   must equal 32 x (prefills + decode steps).

Then the ``kernels`` line, the ``nvidia-smi`` line and the closing
``{"ok": true, ...}`` line. Any failure raises and exits non-zero; without a
CUDA device nothing is printed to stdout.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from functools import partial

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import gmm as gmm_mod  # noqa: E402
from repro_torch.kernels import gmm_swiglu as swiglu_mod  # noqa: E402
from repro_torch.kernels.ref import (gmm_ref, gmm_swiglu_ref,  # noqa: E402
                                     moe_ffn_ref)
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.moe import capacity, moe_grouped  # noqa: E402

ARCH = "granite-moe-3b-a800m"
SLOTS, REQUESTS, PROMPT_LEN, MAX_NEW = 8, 16, 128, 32
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Kernel vs plain version on the card. fp32: the two sum up to 1536
# products in different orders; bf16: the tolerance of the JAX kernel tests.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# One prefill's last-token logits, kernels vs plain expert FFN, bf16 through
# 32 layers: |diff| <= LOGIT_TOL * max|logit|.
LOGIT_TOL = 5e-2

KERNELS = {
    "gmm_swiglu": dict(fn=swiglu_mod.gmm_swiglu, plain=gmm_swiglu_ref,
                       two=True,
                       source="src/repro_torch/kernels/csrc/gmm_swiglu.cu",
                       replaces="src/repro/kernels/gmm_swiglu.py:47"),
    "gmm": dict(fn=gmm_mod.gmm, plain=gmm_ref, two=False,
                source="src/repro_torch/kernels/csrc/gmm.cu",
                replaces="src/repro/kernels/gmm.py:43"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn()`` by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(E, C, K, N, two, dtype):
    """Least time (ms) for the call and what sets it: each input read once,
    the output written once, over HBM; 2 ops per multiply-add over the
    dtype's peak."""
    item = torch.finfo(dtype).bits // 8
    w_cols = 2 * N if two else N
    nbytes = (E * C * K + E * K * w_cols + E * C * N) * item
    ops = 2 * E * C * K * w_cols
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_case(name, E, C, K, N, dtype, gen, timed):
    spec = KERNELS[name]
    w_cols = 2 * N if spec["two"] else N
    x = torch.randn((E, C, K), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((E, K, w_cols), generator=gen, device="cuda")
         * K ** -0.5).to(dtype)
    got = spec["fn"](x, w)
    want = spec["plain"](x, w)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    tol = TOL[dtype]
    ok = bool((err <= tol + tol * want.float().abs()).all())
    row = {"kernel": name, "E": E, "C": C, "K": K, "N": N,
           "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": float(err.max()), "tol": tol, "ok": ok}
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{row}")
    if timed:
        b_ms, b_by = bound(E, C, K, N, spec["two"], dtype)
        row.update(ms=cuda_ms(lambda: spec["fn"](x, w)),
                   plain_ms=cuda_ms(lambda: spec["plain"](x, w)),
                   library_ms=(cuda_ms(lambda: torch.bmm(x, w))
                               if name == "gmm" else None),
                   bound_ms=b_ms, bound_by=b_by)
    return row


def check_kernels(cfg):
    """Phase 3: every kernel against its plain version on the card."""
    mc = cfg.moe
    E, D, Fe = mc.e_total, cfg.d_model, mc.d_expert
    c_dec8, c_dec4 = capacity(SLOTS, mc), capacity(SLOTS // 2, mc)
    c_pre = capacity(PROMPT_LEN, mc)
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    # The serving path's shapes: (C, K, N) of gmm_swiglu (K=D, N=F) and gmm
    # (K=F, N=D), timed in the model's dtype.
    path = {"decode8": c_dec8, "decode4": c_dec4, "prefill": c_pre}
    for dtype in (torch.bfloat16, torch.float32):
        for tag, C in path.items():
            for name, (K, N) in (("gmm_swiglu", (D, Fe)), ("gmm", (Fe, D))):
                r = kernel_case(name, E, C, K, N, dtype, gen,
                                timed=dtype == torch.bfloat16)
                r["shape"] = tag
                rows.append(r)
        # Ragged shapes of the CPU tests (N = 160 and 18 are not multiples
        # of the 64-column tile; 18 is not a multiple of the 4-wide vectors).
        for E_, C, K, N in ((1, 128, 64, 128), (4, 256, 192, 256),
                            (3, 64, 96, 160), (8, 512, 128, 64),
                            (3, 1, 1536, 18), (3, 2, 1536, 40),
                            (3, 27, 1536, 160)):
            rows.append(kernel_case("gmm", E_, C, K, N, dtype, gen, False))
        for E_, C, K, F in ((2, 128, 64, 128), (4, 192, 96, 64),
                            (1, 256, 128, 384), (3, 1, 1536, 18),
                            (3, 2, 1536, 40), (3, 27, 1536, 160)):
            rows.append(kernel_case("gmm_swiglu", E_, C, K, F, dtype, gen,
                                    False))
    return rows, {"decode8": c_dec8, "decode4": c_dec4, "prefill": c_pre}


def plain_moe_impl(cfg):
    """The MoE block with the expert FFN's plain version (check only)."""
    def ffn(x, w_in, w_down, act):
        return moe_ffn_ref(x, w_in.to(x.dtype), w_down.to(x.dtype))
    return partial(moe_grouped, act=cfg.act, gmm_fn=ffn)


def run_slice(cfg):
    """Phase 4: the port's serving path at full width and depth."""
    t = time.perf_counter()
    params = M.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    rng = np.random.default_rng(0)
    prompts = {i: rng.integers(0, cfg.vocab, PROMPT_LEN)
               for i in range(REQUESTS)}
    max_len = PROMPT_LEN + MAX_NEW + 1

    # One prefill through the kernels against the plain expert FFN.
    toks = torch.as_tensor(prompts[0][None, :], device="cuda")
    with torch.inference_mode():
        lk, _ = M.prefill(cfg, params, {"tokens": toks}, max_len)
        lp, _ = M.prefill(cfg, params, {"tokens": toks}, max_len,
                          moe_impl=plain_moe_impl(cfg))
    lk, lp = lk.float(), lp.float()
    if not (bool(torch.isfinite(lk).all()) and bool(torch.isfinite(lp).all())):
        raise AssertionError("non-finite prefill logits")
    logit_err = float((lk - lp).abs().max())
    logit_scale = float(lp.abs().max())
    if logit_err > LOGIT_TOL * logit_scale:
        raise AssertionError(f"kernel-backed prefill logits differ from the "
                             f"plain path: {logit_err} > {LOGIT_TOL} x "
                             f"{logit_scale}")

    torch.cuda.reset_peak_memory_stats()
    gmm_mod.launches = 0
    swiglu_mod.launches = 0
    with torch.inference_mode():
        b, stats = serve_mod.serve(cfg, params, prompts, n_slots=SLOTS,
                                   max_new=MAX_NEW, device="cuda")
    launches = {"gmm_swiglu": swiglu_mod.launches, "gmm": gmm_mod.launches}
    want = cfg.n_layers * (stats["prefills"] + stats["decode_steps"])
    if stats["requests"] != REQUESTS:
        raise AssertionError(f"served {stats['requests']} of {REQUESTS}")
    if any(len(b.generated[r]) != MAX_NEW for r in prompts):
        raise AssertionError("a request has the wrong number of tokens")
    if stats["nonfinite_steps"]:
        raise AssertionError(f"{stats['nonfinite_steps']} steps had "
                             f"non-finite logits")
    if any(n != want for n in launches.values()):
        raise AssertionError(f"launch counts {launches} != {want} = "
                             f"{cfg.n_layers} x (prefills + decode steps)")
    out = {"phase": "slice", "arch": cfg.name, "dtype": cfg.dtype,
           "n_layers": cfg.n_layers, "params": cfg.param_count(),
           "init_s": init_s, "slots": SLOTS, "prompt_len": PROMPT_LEN,
           "max_new": MAX_NEW, "logit_max_abs_err": logit_err,
           "logit_max_abs": logit_scale, "logit_tol": LOGIT_TOL,
           "top1_agree": bool(lk.argmax() == lp.argmax()),
           "launches": launches, "expected_launches": want,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    out.update(stats)
    return out, launches


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t = time.perf_counter()
    libs = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t,
          "libraries": {k: os.path.basename(v) for k, v in libs.items()}})

    cfg = get_config(ARCH)
    rows, caps = check_kernels(cfg)
    emit({"phase": "kernel_checks", "capacities": caps, "rows": rows})

    slice_out, launches = run_slice(cfg)
    emit(slice_out)

    kernels = []
    for name, spec in KERNELS.items():
        # The headline shape: a decode step of the 8-slot batch, the call
        # the serving path makes most often.
        r = next(r for r in rows if r["kernel"] == name
                 and r.get("shape") == "decode8" and r["dtype"] == "bfloat16")
        worst = max(x["max_abs_err"] for x in rows if x["kernel"] == name)
        kernels.append({
            "name": name, "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"], "launches": launches[name],
            "max_abs_err": worst, "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "shape": {k: r[k] for k in ("E", "C", "K", "N", "dtype")}})
    if not all(math.isfinite(k["ms"]) for k in kernels):
        raise AssertionError(f"non-finite kernel time: {kernels}")
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
