"""Deterministic synthetic data — counterpart of ``repro.data.pipeline``.

An infinite, seekable stream of token batches from a counter-based PRNG:
any step's batch can be made again exactly. The body is numpy, copied from
the JAX package, so both give the same tokens bit for bit. The synthetic
distribution is a Zipf-ish marginal with a repeated motif in each row, so
losses move in short runs.

:meth:`SyntheticStream.batch` puts the global batch on one device;
:meth:`SyntheticStream.sharded_batch` builds it data group by data group,
each from its own rows, as the reference assembles a global array from its
shards. On a process mesh (``launch.mesh.dist_mesh(dims)``) it makes this
rank's block alone: the block that the stream's ``rules.batch_spec`` gives
the rank's coords (rows over (pod, data, model) in the zero1 and ep_dp
modes; in tp_sp rows over the data axes and the sequence over ``model``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234


class SyntheticStream:
    """``rules``: the ``parallel.sharding.ShardingRules`` whose batch spec
    places the rows on a process mesh."""

    def __init__(self, dc: DataConfig, rules=None):
        self.dc = dc
        self.rules = rules

    def _tokens(self, step: int, row_lo: int, row_hi: int) -> np.ndarray:
        """Rows [row_lo, row_hi) of the global batch at ``step``."""
        dc = self.dc
        rows = []
        for r in range(row_lo, row_hi):
            rng = np.random.default_rng(
                np.uint64(dc.seed) + np.uint64(step) * np.uint64(1 << 20)
                + np.uint64(r))
            # Zipf-ish marginal, clipped to vocab.
            z = rng.zipf(1.3, size=dc.seq_len + 1).astype(np.int64)
            toks = (z % (dc.vocab - 1)) + 1
            # short-range structure: repeat a motif at a random offset
            m_len = int(rng.integers(4, 16))
            motif = toks[:m_len]
            off = int(rng.integers(0, dc.seq_len - m_len))
            toks[off:off + m_len] = motif
            rows.append(toks)
        return np.stack(rows)

    def global_batch_np(self, step: int):
        t = self._tokens(step, 0, self.dc.global_batch)
        return {"tokens": t[:, :-1].astype(np.int32),
                "labels": t[:, 1:].astype(np.int32)}

    def batch(self, step: int, device) -> dict:
        """The global batch at ``step`` as int64 tensors on ``device``."""
        return {k: torch.as_tensor(v, dtype=torch.long, device=device)
                for k, v in self.global_batch_np(step).items()}

    def sharded_batch(self, step: int, mesh, device) -> dict:
        """The batch at ``step`` over ``mesh``'s data groups (the batch
        split over the pod and data axes, replicated over ``model``): every
        group's rows, concatenated in group order — the global batch, as a
        one-card mesh of virtual ranks holds it. ``mesh=None`` is one data
        group: the global batch, as :meth:`batch` gives it. A process mesh:
        this rank's block (see the module docstring)."""
        if mesh is not None and mesh.local_rows:
            return self._rank_block(step, mesh, device)
        dc, n = self.dc, (1 if mesh is None else mesh.dp_size)
        if dc.global_batch % n:
            raise ValueError(f"global batch {dc.global_batch} does not "
                             f"split over {n} data groups")
        t = self._tokens(step, 0, dc.global_batch)
        return {k: torch.as_tensor(v, dtype=torch.long, device=device)
                for k, v in (("tokens", t[:, :-1]), ("labels", t[:, 1:]))}

    def _rank_block(self, step: int, mesh, device) -> dict:
        from ..parallel.sharding import local_block, spec_axes
        if self.rules is None:
            raise ValueError("a process mesh takes its rows by the stream's "
                             "rules: SyntheticStream(dc, rules=...)")
        B, S = self.dc.global_batch, self.dc.seq_len
        spec = self.rules.batch_spec({"tokens": (B, S)})["tokens"]
        held = set(spec_axes(spec))
        if any(n > 1 and a not in held for a, n in mesh.shape.items()):
            # Each rank's block must be its own share of the batch's mean.
            raise ValueError(
                f"a batch of {B} x {S} tokens does not split over the "
                f"{math.prod(mesh.shape.values())} ranks of mesh "
                f"{mesh.shape} ({self.rules.mode}: {spec})")
        rows, cols = (local_block(torch.arange(n), (e,), mesh, mesh.coords)
                      for n, e in ((B, spec[0]), (S, spec[1])))
        t = self._tokens(step, int(rows[0]), int(rows[-1]) + 1)
        lo, hi = int(cols[0]), int(cols[-1]) + 1
        return {k: torch.as_tensor(v[:, lo:hi], dtype=torch.long,
                                   device=device)
                for k, v in (("tokens", t[:, :-1]), ("labels", t[:, 1:]))}
