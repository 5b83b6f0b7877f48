"""Serving with continuous batching — counterpart of
``repro.launch.serve``.

A request queue feeds fixed-slot batched decoding: a finished sequence
releases its slot to the next request (prefill into the slot; decode goes on
for everyone else). Per-slot cache state lives in one batched cache; a
batch-1 prefill cache is scattered into its slot.

On the card (the default):
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch granite-moe-3b-a800m --requests 16 --slots 8 \\
        --prompt-len 128 --max-new 32
On the CPU, at the smoke size:
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

The scheduling options of the JAX entry point (``--sched``,
``--online-refit``, ``--slo-us``) need the schedule compiler and are not
ported yet.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models import model as M


class ContinuousBatcher:
    """Fixed-slot continuous batching over a batched KV cache.

    ``moe_impl`` replaces the model's MoE block (default: the kernel-backed
    ``moe_grouped``). Every decode step runs the whole slot batch, idle slots
    included, as the JAX batcher does: their tokens take part in routing and
    in the competition for expert capacity.
    """

    def __init__(self, cfg, params, n_slots: int, max_len: int, *,
                 moe_impl=None, device="cuda"):
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
        self.deferred = 0                # defer verdicts (retried later)
        self.instant_done: list[int] = []
        self.n_prefills = 0
        self.n_decode_steps = 0
        self.nonfinite_steps = 0     # prefills/steps with a non-finite logit

    def _check_finite(self, logits) -> None:
        if not bool(torch.isfinite(logits).all()):
            self.nonfinite_steps += 1

    def _scatter_slot(self, slot: int, cache1):
        """Write a batch-1 prefill cache (scalar ``len``) into ``slot``."""
        for c, c1 in zip(self.cache, cache1):
            c["k"][slot] = c1["k"][0]
            c["v"][slot] = c1["v"][0]
            c["len"][slot] = c1["len"]

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

    def offer(self, rid: int, prompt: np.ndarray, max_new: int) -> str:
        """:meth:`admit` as a verdict, ``'admit' | 'defer'``.

        The JAX batcher's admission control (SLO deferral, shedding,
        ``queue_depth``) needs the schedule cost model and is not ported
        yet.
        """
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
          device="cuda", moe_impl=None):
    """Serve ``prompts`` ({id: token array}) to the end.

    Returns ``(batcher, stats)``. Times are host-clock seconds around each
    prefill and decode step; each ends by reading tokens back to the host,
    which waits for the device.
    """
    prompt_len = max(len(p) for p in prompts.values())
    b = ContinuousBatcher(cfg, params, n_slots=n_slots,
                          max_len=prompt_len + max_new + 1,
                          moe_impl=moe_impl, device=device)
    pending = list(prompts)
    finished: list[int] = []
    prefill_s: list[float] = []
    decode_s: list[float] = []
    t0 = time.perf_counter()
    while pending or b.active.any() or b.instant_done:
        while pending:
            t = time.perf_counter()
            if b.offer(pending[0], prompts[pending[0]], max_new) == "defer":
                break
            prefill_s.append(time.perf_counter() - t)
            pending.pop(0)
        busy = b.active.any()
        t = time.perf_counter()
        finished += b.step()
        if busy:
            decode_s.append(time.perf_counter() - t)
        if b.n_decode_steps > 10000:
            raise RuntimeError("serving loop did not converge")
    wall = time.perf_counter() - t0
    if sorted(finished) != sorted(prompts):
        raise RuntimeError("a request did not finish")
    tokens = sum(len(v) for v in b.generated.values())
    stats = {
        "requests": len(finished), "tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "prefills": b.n_prefills, "decode_steps": b.n_decode_steps,
        "prefill_ms_median": 1e3 * statistics.median(prefill_s),
        "decode_step_ms_median": (1e3 * statistics.median(decode_s)
                                  if decode_s else None),
        "nonfinite_steps": b.nonfinite_steps,
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
    args = ap.parse_args(argv)

    from ..configs import get_config, get_smoke_config
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    params = M.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    prompts = {i: rng.integers(0, cfg.vocab, args.prompt_len)
               for i in range(args.requests)}
    b, stats = serve(cfg, params, prompts, n_slots=args.slots,
                     max_new=args.max_new, device=dev)
    print(f"served {stats['requests']} requests / {stats['tokens']} tokens "
          f"in {stats['wall_s']:.2f}s on {dev} "
          f"({stats['tokens_per_s']:.1f} tok/s) over "
          f"{stats['decode_steps']} decode steps ({args.slots} slots)")
    for rid in list(prompts)[:2]:
        print(f"  req{rid}: …{prompts[rid][-4:].tolist()} → "
              f"{b.generated[rid][:10]}…")
    return b, stats


if __name__ == "__main__":
    main()
