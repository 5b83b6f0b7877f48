"""BucketSpec — first-class plan quantization policies (paper §5.1).

The SSC reuse story hinges on mapping data-dependent routing onto a small
set of stable shape buckets: two batches whose per-(src, dst, expert) row
counts quantize to the same values produce identical
:class:`~repro_torch.core.routing.RoutingPlan`\\ s and therefore share one
compiled schedule (one SSC cache entry, one jit trace of the ragged EP
ring). Until this module, that quantization was a single scalar
(``bucket_rows``, linear round-up) threaded ad-hoc through the dropless
path; serving traffic and the ragged EP path got none at all.

A :class:`BucketSpec` is a serializable, hashable quantization policy over
nonzero cell counts. Three policies:

* ``linear(rows)`` — round each nonzero count up to the next multiple of
  ``rows``; ``linear(1)`` is the exact (identity) spec. Constant absolute padding per cell, so tiny cells
  pay a large *relative* padding cost (a 1-row cell pads to ``rows``) and
  large cells outgrow the bucket under jitter.
* ``geometric(base, growth=2)`` — round up to the next rung of the ladder
  ``base, base·g, base·g², …`` (power-of-two style for ``g = 2``). Bucket
  width grows with cell size, which is the right match for multiplicative
  jitter: a cell whose count fluctuates by a few percent stays on one rung
  no matter how hot it is, while cold cells pad only to ``base``.
* ``ladder(edges)`` — an explicit sorted rung list; counts round up to the
  smallest edge ≥ count, and counts above the top edge round up to the
  next *multiple* of the top edge (coverage never fails, growth stays
  bounded). Ladders are what :func:`fit_ladder` learns from an observed
  plan population: the edges minimizing total padded rows for a given rung
  budget — the per-profile bucket ladder the ROADMAP asked for.

Invariants every policy keeps (property-tested in ``tests/test_buckets.py``):

* **coverage** — ``quantize(c) >= c`` for every cell; a schedule compiled
  for the bucketed plan always has room for the exact rows;
* **sparsity** — zero cells stay zero, so the task graph's nonzero-cell
  structure (and the EP ring's skipped steps) is preserved;
* **idempotence** — ``quantize(quantize(c)) == quantize(c)``: bucketed
  plans are fixed points, so re-bucketing a cached plan never forks keys;
* **monotonicity** — ``c1 <= c2`` implies ``quantize(c1) <= quantize(c2)``.

A spec ``B`` *coarsens* a spec ``A`` when ``B(A(c)) == B(c)`` for every
count — ``B``'s buckets are unions of ``A``'s. Coarsening can only merge
cache keys, never split them, so a coarser spec's hit rate on a fixed
trace is never lower (also property-tested). ``geometric(b)`` coarsens
``linear(b)``, and ``linear(k·r)`` coarsens ``linear(r)``.

Serialization: :meth:`BucketSpec.key` is the canonical hashable tuple that
rides the SSC cache key and ``Schedule.opts``/blob;
:meth:`BucketSpec.from_any` accepts a spec, a linear bucket-size int,
a CLI string (``"geometric:8"``), or a serialized key, so every layer can
take whichever form its caller holds.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence, Union

import numpy as np

_POLICIES = ("linear", "geometric", "ladder")


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """A quantization policy over nonzero plan-cell row counts."""

    policy: str = "linear"
    rows: int = 1                      # linear: bucket multiple
    base: int = 8                      # geometric: first rung
    growth: float = 2.0                # geometric: rung ratio
    edges: tuple = ()                  # ladder: sorted rung values
    # Mesh-size tag: bucket ladders are per-mesh-size populations (a plan's
    # cell shape is [ep, ep, e_loc], so a ladder fit at ep=8 says nothing
    # about ep=7 cells). ``None`` = untagged; untagged specs key/print
    # byte-identically to the pre-tag format, so resident cache keys and
    # serialized blobs stay valid. ``SSCCache.rekey_for_mesh`` migrates
    # entries between mesh populations by rewriting this tag.
    ep: Optional[int] = None

    # -- constructors --------------------------------------------------------
    @classmethod
    def linear(cls, rows: int) -> "BucketSpec":
        """Round nonzero counts up to a multiple of ``rows``; ``rows <= 1``
        is the exact/identity spec."""
        return cls(policy="linear", rows=max(1, int(rows)))

    @classmethod
    def geometric(cls, base: int, growth: float = 2.0) -> "BucketSpec":
        """Round nonzero counts up to ``base * growth**k`` rungs."""
        if base < 1:
            raise ValueError(f"geometric base must be >= 1, got {base}")
        if growth <= 1.0:
            raise ValueError(f"geometric growth must be > 1, got {growth}")
        return cls(policy="geometric", base=int(base), growth=float(growth))

    @classmethod
    def ladder(cls, edges: Sequence[int]) -> "BucketSpec":
        """Explicit rung list; counts above the top edge round up to a
        multiple of it."""
        e = tuple(sorted({int(x) for x in edges if int(x) > 0}))
        if not e:
            raise ValueError("ladder needs at least one positive edge")
        return cls(policy="ladder", edges=e)

    @classmethod
    def exact(cls) -> "BucketSpec":
        return cls.linear(1)

    def __post_init__(self):
        if self.policy not in _POLICIES:
            raise ValueError(f"unknown bucket policy {self.policy!r}; "
                             f"choices: {_POLICIES}")
        if self.ep is not None and int(self.ep) < 1:
            raise ValueError(f"bucket ep tag must be >= 1, got {self.ep}")

    def for_mesh(self, ep: Optional[int]) -> "BucketSpec":
        """This policy tagged to the ``ep``-rank mesh population
        (``None`` untags). Quantization is unchanged — the tag only
        separates cache-key populations per mesh size."""
        ep = int(ep) if ep is not None else None
        if ep == self.ep:
            return self
        return dataclasses.replace(self, ep=ep)

    # -- identity / serialization -------------------------------------------
    def key(self) -> tuple:
        """Canonical hashable identity (rides the SSC cache key and blob).

        ``linear(rows)`` keys as ``("linear", rows)`` — by construction the
        same tuple whether it came from an int or an explicit spec. A mesh
        tag appends ``("ep", n)``:
        ``linear(16).for_mesh(4)`` keys as ``("linear", 16, ("ep", 4))``,
        while untagged specs keep the pre-tag byte-identical form.
        """
        if self.policy == "linear":
            k = ("linear", self.rows)
        elif self.policy == "geometric":
            k = ("geometric", self.base, self.growth)
        else:
            k = ("ladder", self.edges)
        if self.ep is not None:
            k = k + (("ep", self.ep),)
        return k

    def spec(self) -> list:
        """msgpack/JSON-safe form of :meth:`key` (tuples become lists)."""
        k = self.key()
        return [list(x) if isinstance(x, tuple) else x for x in k]

    @property
    def is_exact(self) -> bool:
        return self.policy == "linear" and self.rows <= 1

    def __str__(self) -> str:
        if self.policy == "linear":
            s = f"linear:{self.rows}"
        elif self.policy == "geometric":
            g = (f"x{self.growth:g}" if self.growth != 2.0 else "")
            s = f"geometric:{self.base}{g}"
        else:
            s = "ladder:" + ",".join(str(e) for e in self.edges)
        return s + (f"@ep{self.ep}" if self.ep is not None else "")

    @classmethod
    def parse(cls, text: str) -> "BucketSpec":
        """Parse the CLI form: ``"16"`` (legacy linear), ``"exact"``,
        ``"linear:16"``, ``"geometric:8"``, ``"geometric:8x1.5"``,
        ``"ladder:4,8,32"``; any form takes an ``@epN`` mesh-tag suffix
        (``"linear:16@ep4"``)."""
        t = text.strip().lower()
        if "@" in t:
            t, _, tag = t.rpartition("@")
            if not tag.startswith("ep") or not tag[2:].isdigit():
                raise ValueError(
                    f"bucket spec {text!r}: mesh tag must be '@epN'")
            return cls.parse(t).for_mesh(int(tag[2:]))
        if t in ("exact", "none", "1"):
            return cls.exact()
        if ":" not in t:
            try:
                return cls.linear(int(t))
            except ValueError:
                raise ValueError(
                    f"bucket spec {text!r}: expected an int (linear "
                    f"rows) or policy:params "
                    f"(linear:R | geometric:B[xG] | ladder:E1,E2,...)")
        policy, _, params = t.partition(":")
        if policy == "linear":
            return cls.linear(int(params))
        if policy == "geometric":
            if "x" in params:
                b, _, g = params.partition("x")
                return cls.geometric(int(b), float(g))
            return cls.geometric(int(params))
        if policy == "ladder":
            return cls.ladder([int(x) for x in params.split(",") if x])
        raise ValueError(f"unknown bucket policy {policy!r} in {text!r}; "
                         f"choices: {_POLICIES}")

    @classmethod
    def from_any(cls, obj: Union["BucketSpec", int, str, Sequence, None],
                 ) -> "BucketSpec":
        """Normalize any accepted bucket argument to a spec.

        ``None`` is exact and an int ``r`` is ``linear(r)`` (``<= 1`` =
        exact); strings go through :meth:`parse`;
        tuples/lists are serialized :meth:`key`/:meth:`spec` forms.
        """
        if obj is None:
            return cls.exact()
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, (int, np.integer)):
            return cls.linear(int(obj))
        if isinstance(obj, str):
            return cls.parse(obj)
        if isinstance(obj, (tuple, list)) and obj \
                and isinstance(obj[0], str):
            ep = None
            if (len(obj) > 1 and isinstance(obj[-1], (tuple, list))
                    and len(obj[-1]) == 2 and obj[-1][0] == "ep"):
                ep = int(obj[-1][1])
                obj = obj[:-1]
            policy = obj[0]
            spec = None
            if policy == "linear":
                spec = cls.linear(obj[1])
            elif policy == "geometric":
                spec = cls.geometric(obj[1], obj[2] if len(obj) > 2 else 2.0)
            elif policy == "ladder":
                spec = cls.ladder(obj[1])
            if spec is not None:
                return spec.for_mesh(ep) if ep is not None else spec
        raise TypeError(f"cannot interpret {obj!r} as a BucketSpec")

    # -- quantization --------------------------------------------------------
    def _rungs_through(self, top: int) -> np.ndarray:
        """Geometric rung values covering counts up to ``top``."""
        rungs = [self.base]
        while rungs[-1] < top:
            nxt = int(np.ceil(rungs[-1] * self.growth))
            rungs.append(max(nxt, rungs[-1] + 1))
        return np.asarray(rungs, dtype=np.int64)

    def quantize(self, counts) -> np.ndarray:
        """Quantize a count array cell-wise: nonzero counts round *up* to
        their policy bucket, zeros stay zero (sparsity preserved)."""
        c = np.asarray(counts, dtype=np.int64)
        if self.is_exact or c.size == 0:
            return c.copy() if c is counts else c
        top = int(c.max()) if c.size else 0
        if self.policy == "linear":
            q = -(-c // self.rows) * self.rows
        elif self.policy == "geometric":
            rungs = self._rungs_through(max(top, self.base))
            idx = np.searchsorted(rungs, c, side="left")
            q = rungs[np.minimum(idx, len(rungs) - 1)]
        else:
            edges = np.asarray(self.edges, dtype=np.int64)
            idx = np.searchsorted(edges, c, side="left")
            inside = idx < len(edges)
            q = np.where(inside, edges[np.minimum(idx, len(edges) - 1)], 0)
            # Above the top edge: next multiple of the top edge, so
            # coverage holds for any future count the fit never saw.
            e_top = int(edges[-1])
            q = np.where(inside, q, -(-c // e_top) * e_top)
        return np.where(c > 0, q, 0)

    def apply(self, plan):
        """Bucketed :class:`~repro_torch.core.routing.RoutingPlan` of ``plan``.

        The returned plan covers ``plan`` cell-wise with identical
        sparsity; exact specs return ``plan`` unchanged (same object, so
        cached identity survives).
        """
        from .routing import RoutingPlan
        if self.is_exact:
            return plan
        q = self.quantize(np.asarray(plan.counts, dtype=np.int64))
        if (q == np.asarray(plan.counts)).all():
            return plan
        return RoutingPlan.from_counts(q)

    def pad_ratio(self, counts) -> float:
        """Padded rows / exact rows for one count matrix (1.0 = no pad)."""
        c = np.asarray(counts, dtype=np.int64)
        total = int(c.sum())
        return float(self.quantize(c).sum()) / total if total else 1.0

    def pad_rows(self, counts) -> int:
        """Absolute padded-row overhead for one count matrix (>= 0).

        The padding term of the online tuner's swap criterion
        (``launch/online.py``) — additive across a window where
        :meth:`pad_ratio` is not."""
        c = np.asarray(counts, dtype=np.int64)
        return int(self.quantize(c).sum() - c.sum())


def coarsens(coarse: BucketSpec, fine: BucketSpec,
             counts: Iterable[int]) -> bool:
    """Check ``coarse``'s buckets are unions of ``fine``'s on ``counts``.

    When true, ``fine(c1) == fine(c2)`` implies ``coarse(c1) ==
    coarse(c2)`` for every pair in ``counts`` — coarsening merges cache
    keys, never splits them, so the coarse spec's hit rate on a trace over
    these counts is never lower than the fine spec's.
    """
    c = np.asarray(list(counts), dtype=np.int64)
    return bool((coarse.quantize(fine.quantize(c))
                 == coarse.quantize(c)).all())


# ---------------------------------------------------------------------------
# Ladder fitting — learn a per-profile rung list from observed plans.
# ---------------------------------------------------------------------------

def _cell_intervals(plans) -> tuple[np.ndarray, list[tuple[int, int]], int]:
    """(stacked counts, per-cell observed nonzero [min, max] ranges,
    n_plans) over a same-shape plan population."""
    mats = []
    for p in plans:
        counts = getattr(p, "counts", None)
        if counts is None:
            counts = getattr(getattr(p, "plan", None), "counts", p)
        mats.append(np.asarray(counts, dtype=np.int64))
    stacked = np.stack(mats)                        # [n_plans, ...cells]
    flat = stacked.reshape(stacked.shape[0], -1)
    ivals = []
    for c in range(flat.shape[1]):
        col = flat[:, c][flat[:, c] > 0]
        if col.size:
            ivals.append((int(col.min()), int(col.max())))
    return flat, ivals, stacked.shape[0]


def fit_ladder(plans, budget: int, split_penalty: float = 0.5) -> BucketSpec:
    """Fit an explicit bucket ladder from an observed plan population.

    Chooses at most ``budget`` edges (a subset of the observed distinct
    nonzero cell counts, always including the maximum) by exact DP over two
    costs the ladder trades between:

    * **padding** — total padded rows when every observed count rounds up
      to its next edge (the classic 1-D quantization objective);
    * **key-flip risk** — a plan's cache key only repeats when *every*
      cell lands on the same rung, so an edge placed inside some cell's
      observed count range [min, max] lets that cell hop rungs under
      jitter and forks the key. Each such straddled interval charges
      ``split_penalty`` × the population's mean per-cell rows, pushing
      edges into the gaps *between* cell ranges.

    ``split_penalty=0`` is padding-optimal in-sample (``budget >= n``
    distinct counts then reproduces the population itself — the exact-keys
    regime); larger values buy reuse with padding, degenerating to one
    rung per merged band of overlapping cell ranges. The replay harness
    (``launch/replay.py``) produces the plan populations this learns from,
    per traffic profile; fit on one trace segment and evaluate on another
    (``bench_dropless`` fits on a held-out seed).

    All plans must share one ``[ep, ep, e_loc]`` cell shape — cell
    identity across the population is what defines the flip risk.
    """
    if budget < 1:
        raise ValueError(f"ladder budget must be >= 1, got {budget}")
    if split_penalty < 0:
        raise ValueError(
            f"split_penalty must be >= 0, got {split_penalty}")
    flat, ivals, n_plans = _cell_intervals(plans)
    pool = flat[flat > 0]
    if pool.size == 0:
        raise ValueError("fit_ladder: no nonzero cell counts in the plans")
    vals, freq = np.unique(pool, return_counts=True)
    n = len(vals)
    if budget >= n and split_penalty == 0:
        return BucketSpec.ladder(vals.tolist())

    # Straddle census: intervals an edge between vals[j] and vals[j+1]
    # would cut (the cell takes values on both sides of the boundary).
    straddles = np.zeros(n, dtype=np.int64)
    for lo, hi in ivals:
        straddles += ((vals >= lo) & (vals < hi))
    mean_cell_rows = float(pool.sum()) / max(1, len(ivals)) / max(1, n_plans)
    # Penalty is in padded-row units: one straddled cell ≈ re-padding that
    # cell's mean rows once per plan in the population.
    boundary_cost = split_penalty * straddles * mean_cell_rows * n_plans

    csum_f = np.concatenate([[0], np.cumsum(freq)])
    csum_fv = np.concatenate([[0], np.cumsum(freq * vals)])

    def seg_pad(i: int, j: int) -> int:
        # sum_{t=i..j} freq[t] * (vals[j] - vals[t])
        return int(vals[j]) * int(csum_f[j + 1] - csum_f[i]) \
            - int(csum_fv[j + 1] - csum_fv[i])

    def pen(j: int) -> float:
        return 0.0 if j == n - 1 else float(boundary_cost[j])

    INF = float("inf")
    kmax = min(budget, n)
    # dp[k][j] = min cost covering v[0..j] with k edges, last edge v[j].
    dp = [[INF] * n for _ in range(kmax + 1)]
    back = [[-1] * n for _ in range(kmax + 1)]
    for j in range(n):
        dp[1][j] = seg_pad(0, j) + pen(j)
    for k in range(2, kmax + 1):
        for j in range(k - 1, n):
            best, arg = INF, -1
            for i in range(k - 2, j):
                cand = dp[k - 1][i] + seg_pad(i + 1, j) + pen(j)
                if cand < best:
                    best, arg = cand, i
            dp[k][j], back[k][j] = best, arg
    # Fewer edges than the budget may cost less once boundaries are priced.
    k = min(range(1, kmax + 1), key=lambda kk: dp[kk][n - 1])
    edges = [int(vals[n - 1])]
    j = n - 1
    while k > 1 and back[k][j] >= 0:
        j = back[k][j]
        edges.append(int(vals[j]))
        k -= 1
    return BucketSpec.ladder(edges)
