"""Batched serving: prefill a batch of prompts, decode N tokens greedily —
counterpart of ``examples/serve_decode.py``.

The inference path the dry run's decode cells count: KV-cache prefill,
then one-token decode steps. A MoE arch's expert FFN runs the GMM kernels
on the card (the model's normal MoE path). Times are the host's clock
around the device's work, first calls included.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_decode [--arch mamba2-1.3b]
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_smoke_config
from ..device import resolve_device
from ..models import model as M


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b",
                    help="any non-encoder arch id (smoke-scaled)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init_params(cfg, gen, device=dev)
    B, P = args.batch, args.prompt_len
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
    max_len = P + args.gen

    with torch.inference_mode():
        t0 = time.perf_counter()
        last, cache = M.prefill(cfg, params, {"tokens": prompts}, max_len)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        tok = torch.argmax(last, -1)[:, None]
        toks = [tok]
        t0 = time.perf_counter()
        for _ in range(args.gen - 1):
            logits, cache = M.decode_step(cfg, params, tok, cache)
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            toks.append(tok)
        _sync(dev)
        t_decode = time.perf_counter() - t0
    out = torch.cat(toks, 1).cpu()

    print(f"arch={cfg.name} batch={B} prompt={P} gen={args.gen} "
          f"device={dev}")
    print(f"prefill: {t_prefill * 1e3:.1f}ms   "
          f"decode: {t_decode / max(1, args.gen - 1) * 1e3:.2f}ms/token "
          f"(first calls included)")
    for b in range(min(B, 2)):
        print(f"  seq{b}: {prompts[b, -6:].tolist()} → {out[b].tolist()}")
    return {"arch": cfg.name, "tokens": out, "prefill_s": t_prefill,
            "decode_s": t_decode}


if __name__ == "__main__":
    main()
