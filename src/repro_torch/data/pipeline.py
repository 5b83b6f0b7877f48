"""Deterministic synthetic data — counterpart of ``repro.data.pipeline``.

An infinite, seekable stream of token batches from a counter-based PRNG:
any step's batch can be made again exactly. The body is numpy, copied from
the JAX package, so both give the same tokens bit for bit. The synthetic
distribution is a Zipf-ish marginal with a repeated motif in each row, so
losses move in short runs.

:meth:`SyntheticStream.batch` puts the global batch on one device;
:meth:`SyntheticStream.sharded_batch` builds it data group by data group,
each from its own rows, as the reference assembles a global array from its
shards, or gives one data group's rows only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234


class SyntheticStream:
    def __init__(self, dc: DataConfig):
        self.dc = dc

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

    def sharded_batch(self, step: int, mesh, device,
                      data_rank=None) -> dict:
        """The batch at ``step`` over ``mesh``'s data groups (the batch
        split over the pod and data axes, replicated over ``model``).

        ``data_rank=None``: every group's rows, concatenated in group order
        — the global batch, as a one-card mesh of virtual ranks holds it.
        An int: that group's rows only, which every rank of its model group
        holds (a ``DistComm`` process passes its own). ``mesh=None`` is one
        data group: the global batch, as :meth:`batch` gives it.
        """
        dc, n = self.dc, (1 if mesh is None else mesh.dp_size)
        if dc.global_batch % n:
            raise ValueError(f"global batch {dc.global_batch} does not "
                             f"split over {n} data groups")
        per = dc.global_batch // n
        groups = range(n) if data_rank is None else [data_rank]
        t = np.concatenate([self._tokens(step, g * per, (g + 1) * per)
                            for g in groups])
        return {k: torch.as_tensor(v, dtype=torch.long, device=device)
                for k, v in (("tokens", t[:, :-1]), ("labels", t[:, 1:]))}
