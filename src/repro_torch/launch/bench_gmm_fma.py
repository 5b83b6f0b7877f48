"""Per-call times of the grouped GEMMs' fp32 bodies: the FMA body
(``csrc/gmm_common.cuh``) and ``gmm``'s tiled, narrow and small-row bodies
(``csrc/gmm_fp32.cuh``, ``csrc/gmm_fp32_narrow.cuh``,
``csrc/gmm_fp32_small.cuh``).

Every fp32 ``gmm_swiglu`` call runs the FMA body; an fp32 ``gmm`` call runs
the body ``gmm.fp32_body`` names (the tiled body where ``gmm.tiled_takes``
the call, the narrow body for smaller calls, the small-row body where
neither takes it). This script holds each call
against its plain version and times it beside its bound, at the shapes
those callers give it on granite-moe-3b-a800m (d 1536, 48 experts of
F = 512, top-8, T = 4096 tokens):

* the dropless fragment's GMM tiles: E = 1, fp32, at ragged row counts:
  GMM1 and GMM2 (x·W) and their activation gradients (x·Wᵀ, w a transposed
  view); at an expert's mean share of rows, C = 683, also their weight
  gradients (xᵀ·dy, x a transposed view, summing over the rows);
* the fixed-capacity layer in fp32, E = 48 at its training capacity
  C = 854: ``gmm_swiglu`` (GMM1 + SwiGLU) and ``gmm`` (GMM2).

On the card (the default):
    PYTHONPATH=src python -m repro_torch.launch.bench_gmm_fma
On the CPU, at the smoke config's widths, checks only (no times):
    PYTHONPATH=src python -m repro_torch.launch.bench_gmm_fma \\
        --device cpu --smoke

The script imports the package absolutely, so it can time another
checkout's kernels: run this file with that checkout's ``src`` first on
``PYTHONPATH`` (each checkout builds its own libraries under its own
``build/``). Each output row names the body it ran and, by one hash
(``fp32_bodies``), the fp32 bodies' headers it was built from (a checkout
without the narrow body runs the small-row body under the threshold).

``--tiles`` also times each fp32 ``gmm`` call through its C entry with
every body code the call can take, whatever ``gmm.fp32_tile`` would pick:
0 (the small-row body, or the FMA body in a checkout without it), each of
the tiled body's tiles (``gmm.FP32_TILES``) and, where its tensor maps
describe the call, each of the narrow body's configurations
(``gmm.FP32_NARROW``): the measurement behind the tile rule, the narrow
body's rule and the row threshold. Every body's result must be bit-equal
to the others'.

``ms`` is the device time per call by CUDA-graph replay; ``bound_ms`` the
larger of the bytes (each input read once, the output written once, over
HBM) and the operations (2 per multiply-add, over fp32's peak) over the
H100 SXM's data-sheet rates; ``chain_ms`` the K dependent FMAs of one
output at ``FMA_CYCLES`` cycles each and ``CLOCK_GHZ``, which no fp32 body
can beat (each output is one chain). Output: one JSON object per line, the
card's ``name, power.limit``, then a JSON summary (also written to
``--out``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
from pathlib import Path

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels import gmm as gmm_mod
from repro_torch.kernels import gmm_swiglu as swiglu_mod
from repro_torch.kernels import work
from repro_torch.kernels.ref import gmm_ref, gmm_swiglu_ref
from repro_torch.models.moe import capacity

ARCH = "granite-moe-3b-a800m"
TOKENS = 4096
ROWS = (8, 9, 17, 127, 683, 1001)    # 683: an expert's mean share
GRAD_ROWS = 683
TOL = 1e-4                      # fp32, |got - want| <= TOL·(1 + |want|)
# The chain floor: an FMA's latency in cycles and the H100 SXM's boost
# clock (the small-row body's header).
FMA_CYCLES, CLOCK_GHZ = 4, 1.76


def cases(cfg, rows):
    """(name, E, C, K, N, x_layout, w_layout, swiglu) of each timed call;
    N is the output width (F for ``gmm_swiglu``, whose w is [E, K, 2F])."""
    D, F, E = cfg.d_model, cfg.moe.d_expert, cfg.moe.e_total
    out = []
    for C in rows:
        out += [("dropless_gmm1", 1, C, D, 2 * F, 0, 0, False),
                ("dropless_gmm2", 1, C, F, D, 0, 0, False),
                ("dropless_gmm1_act_grad", 1, C, 2 * F, D, 0, 1, False),
                ("dropless_gmm2_act_grad", 1, C, D, F, 0, 1, False)]
    C = GRAD_ROWS if GRAD_ROWS in rows else rows[-1]
    out += [("dropless_gmm1_wgrad", 1, D, C, 2 * F, 1, 0, False),
            ("dropless_gmm2_wgrad", 1, F, C, D, 1, 0, False)]
    cap = capacity(TOKENS, cfg.moe)
    out += [("fixed_gmm_swiglu", E, cap, D, F, 0, 0, True),
            ("fixed_gmm", E, cap, F, D, 0, 0, False)]
    return out


def bound(E, C, K, N, swiglu):
    """Least ms for the fp32 call, and whether bytes or operations set it
    (``kernels.work``)."""
    f32 = torch.float32
    return work.bound_ms(*work.gmm_work(E, C, K, N, f32, swiglu), f32)


def cuda_ms(fn, iters: int = 20, reps: int = 3) -> float:
    """Mean device ms of ``fn()``: ``iters`` calls captured in one CUDA
    graph after a warm-up call, replayed ``reps`` times between events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * reps)


# Body code 0's fp32 body: the small-row body, or the FMA body in a
# checkout without it; the narrow body's codes (none in a checkout without
# it).
CODE0 = "small" if hasattr(gmm_mod, "launches_fp32_small") else "fma"
NARROW = getattr(gmm_mod, "FP32_NARROW", {})


def body_of(x, w, swiglu) -> str:
    """The fp32 body a call runs; "fma" in a checkout without the tiled
    body."""
    fp32_body = getattr(gmm_mod, "fp32_body", None)
    return "fma" if swiglu or fp32_body is None else fp32_body(x, w)


def body_codes(x, w, layouts):
    """(code, body, shape) of every body code the call can take: 0, each
    tiled tile (BM, BN), each narrow configuration (TM, TN, W, CL) where
    the narrow body's tensor maps describe the call."""
    out = [(0, CODE0, None)]
    out += [(c, "tiled", t) for c, t in gmm_mod.FP32_TILES.items()]
    if NARROW and gmm_mod.narrow_usable(x, w, *layouts):
        out += [(c, "narrow", t) for c, t in NARROW.items()]
    return out


def ctas(E, C, N, code, body):
    """CTAs of body code ``code`` on a call; None for code 0."""
    if body == "tiled":
        bm, bn = gmm_mod.FP32_TILES[code]
    elif body == "narrow":
        bm, bn = gmm_mod.narrow_rows(code), gmm_mod.narrow_cols(code)
    else:
        return None
    return E * -(-C // bm) * -(-N // bn)


def tile_rows(row, x, w, want, dev):
    """The ``--tiles`` rows of one gmm call: each body code through the C
    entry, checked against ``want``, timed; every body's result bit-equal
    to the others' (the FMA body of an old checkout excepted)."""
    E, C, K = x.shape
    N = w.shape[-1]
    layouts = gmm_mod.operand_layout(x, "x"), gmm_mod.operand_layout(w, "w")
    out, first = [], None
    for code, body, shape in body_codes(x, w, layouts):
        y = torch.empty((E, C, N), device=dev)

        def call():
            build.launch("gmm", x, w, y, E, C, K, N, *layouts, code,
                         dtype=x.dtype)
        call()
        err = (y - want).abs()
        if not bool((err <= TOL + TOL * want.abs()).all()):
            raise AssertionError(f"{row['call']} at body code {code} "
                                 f"disagrees with its plain version")
        if body != "fma":
            if first is not None and not torch.equal(y, first):
                raise AssertionError(f"{row['call']}: body code {code} "
                                     f"differs from another's result")
            first = y.clone()
        out.append({"call": row["call"], "C": C, "K": K, "N": N,
                    "code": code, "body": body, "shape": shape,
                    "ctas": ctas(E, C, N, code, body),
                    "max_abs_err": float(err.max()),
                    "ms": cuda_ms(call), "bound_ms": row["bound_ms"],
                    "chain_ms": row["chain_ms"]})
    return out


def run_case(case, gen, dev, tiles=False):
    name, E, C, K, N, la, lb, swiglu = case
    w_cols = 2 * N if swiglu else N
    x = torch.randn((E, K, C) if la else (E, C, K), generator=gen,
                    device=dev)
    w = torch.randn((E, w_cols, K) if lb else (E, K, w_cols), generator=gen,
                    device=dev) * K ** -0.5
    x = x.transpose(1, 2) if la else x
    w = w.transpose(1, 2) if lb else w
    fn = swiglu_mod.gmm_swiglu if swiglu else gmm_mod.gmm
    plain = gmm_swiglu_ref if swiglu else gmm_ref
    got = fn(x, w)
    want = plain(x.contiguous(), w.contiguous())
    err = (got - want).abs()
    ok = bool((err <= TOL + TOL * want.abs()).all())
    row = {"call": name, "kernel": "gmm_swiglu" if swiglu else "gmm",
           "E": E, "C": C, "K": K, "N": N,
           "x": "transposed view" if la else "contiguous",
           "w": "transposed view" if lb else "contiguous",
           "body": body_of(x, w, swiglu),
           "max_abs_err": float(err.max()), "tol": TOL, "ok": ok}
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{row}")
    b_ms, b_by = bound(E, C, K, N, swiglu)
    row.update(bound_ms=b_ms, bound_by=b_by,
               chain_ms=K * FMA_CYCLES / (CLOCK_GHZ * 1e6))
    if dev.type == "cuda":
        if not torch.equal(got, fn(x, w)):
            raise AssertionError(f"{name}: two calls on the same input "
                                 f"differ")
        row.update(ms=cuda_ms(lambda: fn(x, w)),
                   plain_ms=cuda_ms(lambda: plain(x, w)),
                   library_ms=None if swiglu else cuda_ms(
                       lambda: torch.bmm(x, w)))
        row["ms_over_bound"] = row["ms"] / b_ms
        if tiles and not swiglu:
            row["tiles"] = tile_rows(row, x, w, want, dev)
    return row


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config's widths (CPU-sized)")
    ap.add_argument("--rows", default=",".join(map(str, ROWS)),
                    help="comma-separated row counts of the dropless tiles")
    ap.add_argument("--tiles", action="store_true",
                    help="also time every body code at each fp32 gmm call "
                         "(the card only)")
    ap.add_argument("--label", default="",
                    help="a name for this run, copied into the summary")
    ap.add_argument("--out", default=None, help="also write the summary here")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke_config(ARCH) if args.smoke else get_config(ARCH)
    csrc = Path(gmm_mod.__file__).resolve().parent / "csrc"
    h = hashlib.sha256()
    for name in ("gmm_common.cuh", "gmm_fp32.cuh", "gmm_fp32_narrow.cuh",
                 "gmm_fp32_small.cuh"):
        if (csrc / name).exists():
            h.update((csrc / name).read_bytes())
    bodies = h.hexdigest()[:12]
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for case in cases(cfg, [int(r) for r in args.rows.split(",")]):
        row = run_case(case, gen, dev, tiles=args.tiles)
        row["fp32_bodies"] = bodies
        rows.append(row)
        print(json.dumps(row), flush=True)
    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(card, flush=True)
    out = {"label": args.label, "package": str(csrc.parents[2]),
           "fp32_bodies": bodies, "card": card, "rows": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: out[k] for k in ("label", "fp32_bodies", "card")}),
          flush=True)
    return out


if __name__ == "__main__":
    main()
