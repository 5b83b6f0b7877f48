"""Static Schedule Configuration (SSC) — copy of ``repro.core.ssc``.

SSC is the serialized execution plan a rank's unified runtime consumes:
CTQ/VTQ task sequences, TD metadata, dependency events, and thresholds
(§3, §5.1). For a fixed shape bucket, EP size, and rank the SSC is compiled
once and reused across training steps; each step supplies only fresh tensor
pointers and zeroed event-counter state.

The blob is UTF-8 JSON of the reference's payload (the reference packs the
same payload with msgpack, which the port does not use): event ids are
string keys there too, tuples come back as lists in both formats, so a
decoded :class:`Schedule` equals the reference's decoded schedule field for
field. Byte counts in ``info()`` differ from the reference's with the
format. The blob records the schedule-pass pipeline spec that produced it
(``Schedule.opts["pipeline"]``). An in-process :class:`SSCCache` keyed by
shape bucket × pipeline mirrors the paper's "reuse SSC for stable shapes or
shape buckets" behaviour (Table 2), with LRU eviction bounding it.
Multi-fragment (fused) schedules come with the port's fusion slice; their
entry points raise until then.

Cache keying and bucketing semantics
------------------------------------

:meth:`SSCCache.key` identifies a compiled schedule by::

    (ep, e_loc, d_model, d_ff, dtype_bytes,
     gmm_m_split, gmm_split_mode,
     cfg.routing.counts,          # the full per-(src, dst, expert) matrix
     cfg.bucket @ ep,             # BucketSpec.key() tagged for_mesh(ep), or None
     cfg.topology.key(),          # cluster link shape (or None = flat links)
     cfg.dispatch_mode, cfg.xnode_compress,
     direction, pipeline.key())

Three properties follow:

* **Resolved-``auto`` keying.** ``pipeline="auto"`` resolves through the
  cost-model-guided selector (``core/autoselect.py``) *before* keying: the
  key is built from the resolved pipeline spec and the (possibly re-tiled)
  resolved config, never the literal ``"auto"``. An ``"auto"`` request and
  the equivalent explicit request share one entry, and every cached blob
  stays addressable by the spec that actually compiled it.

* **Effective-routing keying.** The key uses ``cfg.routing`` — the plan
  that actually drives extents — so a ``ScheduleConfig(rows=r)`` balanced
  grid and an explicit ``RoutingPlan.balanced(ep, e_loc, r)`` share one
  entry, while any genuinely different per-cell count matrix compiles (and
  caches) a fresh SSC. Legacy boolean kwargs (``ratr=`` …) and the
  equivalent ``pipeline=`` spec normalize to the same canonical pipeline
  and share one entry.

* **Bucketed-plan keys.** The dropless training path never inserts exact
  per-batch plans directly:
  ``models.moe.plan_from_routing(bucket=BucketSpec...)`` quantizes each
  nonzero cell count up to its policy bucket — ``linear(rows)`` (an int
  ``bucket`` keys identically), ``geometric(base)``, or a fitted
  ``ladder(edges)`` (see ``repro_torch.core.buckets``) — *before* the plan
  reaches the cache, so every batch whose counts land in the same buckets
  maps to the same ``cfg.routing.counts`` tuple — one key, one compile.
  ``cfg.bucket``
  carries the spec's canonical ``key()`` tuple into the cache key (so two
  policies that happen to map one batch to the same counts still never
  alias) and ``get_or_compile`` records it in ``Schedule.opts["bucket"]``
  / the blob for provenance. Padding rows are zero-filled in the
  executor's send buffers and provably do not change results (zeros
  propagate through GMM/SwiGLU and are never gathered by Combine). Exact
  plans (``bucket=1`` / ``BucketSpec.exact()``) key every distinct
  routing as a miss — the recompile-rate baseline ``bench_dropless``
  measures.

``info()`` reports cumulative ``hits``/``misses``/``evictions`` plus
occupancy; ``step_stats()`` returns the *deltas* since its previous call —
the per-training-step recompile counters the dropless step surfaces in its
metrics dict. Consumers that bucket plans additionally report the rows
they padded (``record_rows``): ``info()``/``step_stats()`` then carry a
cumulative / per-step ``pad_ratio`` (bucketed plan rows / exact routed
rows, 1.0 = no padding), so bucket policies are comparable straight from
the ``ssc_*`` train metrics next to the hit/miss counters they trade
against.
"""

from __future__ import annotations

import dataclasses
import json
from collections import OrderedDict
from typing import Optional

from .odg import ScheduleConfig
from .passes import resolve_pipeline
from .scheduler import Event, Schedule
from .tasks import Range, TaskDescriptor

_FUSION = ("multi-fragment (fused) schedules come with the port's fusion "
           "slice")


def _td_to_dict(td: TaskDescriptor) -> dict:
    d = dataclasses.asdict(td)
    d["inputs"] = [dataclasses.asdict(r) for r in td.inputs]
    d["outputs"] = [dataclasses.asdict(r) for r in td.outputs]
    return d


def _td_from_dict(d: dict) -> TaskDescriptor:
    d = dict(d)
    d["inputs"] = [Range(**r) for r in d["inputs"]]
    d["outputs"] = [Range(**r) for r in d["outputs"]]
    return TaskDescriptor(**d)


def schedule_to_ssc(s: Schedule) -> bytes:
    """Serialize a full (all-rank) schedule.

    Multi-fragment schedules (the reference's ``core/fusion``) come with
    the port's fusion slice and are refused here.
    """
    payload = {
        "version": 1,
        "direction": s.direction,
        "ep": s.ep,
        "opts": s.opts,
        "tasks": [_td_to_dict(td) for td in s.tasks],
        "events": {str(e.eid): {"threshold": e.threshold,
                                "home_rank": e.home_rank,
                                "producers": list(e.producers)}
                   for e in s.events.values()},
        "queues": [{"rank": r, "qtype": q, "tids": tids}
                   for (r, q), tids in sorted(s.queues.items())],
    }
    if getattr(s, "fragments", None):
        raise NotImplementedError(_FUSION)
    return json.dumps(payload, separators=(",", ":")).encode()


def ssc_to_schedule(blob: bytes) -> Schedule:
    p = json.loads(blob)
    tasks = [_td_from_dict(d) for d in p["tasks"]]
    events = {int(k): Event(eid=int(k), threshold=v["threshold"],
                            home_rank=v["home_rank"],
                            producers=tuple(v["producers"]))
              for k, v in p["events"].items()}
    queues = {(e["rank"], e["qtype"]): list(e["tids"]) for e in p["queues"]}
    if p.get("fragments"):
        raise NotImplementedError(_FUSION)
    return Schedule(direction=p["direction"], ep=p["ep"], tasks=tasks,
                    events=events, queues=queues, opts=p.get("opts", {}))


def rank_view(s: Schedule, rank: int) -> dict:
    """The per-rank slice a device runtime would receive (debug/JSON)."""
    tids = set(s.queue(rank, "CTQ")) | set(s.queue(rank, "VTQ"))
    return {
        "rank": rank,
        "ctq": [_td_to_dict(s.tasks[t]) for t in s.queue(rank, "CTQ")],
        "vtq": [_td_to_dict(s.tasks[t]) for t in s.queue(rank, "VTQ")],
        "events": {e.eid: e.threshold for e in s.events.values()
                   if e.home_rank == rank
                   or any(p in tids for p in e.producers)},
    }


def dump_json(s: Schedule, path: str) -> None:
    with open(path, "w") as f:
        json.dump([rank_view(s, r) for r in range(s.ep)], f, indent=1)


class SSCCache:
    """LRU cache of compiled SSCs keyed by shape bucket + pass pipeline
    (paper §5.1).

    ``max_entries`` bounds the cache — the dropless per-batch-plan direction
    compiles one SSC per distinct RoutingPlan, so unbounded growth is a
    production blocker. Least-recently-used blobs are evicted; ``info()``
    reports occupancy and hit/miss/eviction counters.

    Schedules are requested either with ``pipeline=`` (a Pipeline, a pass
    name list, or a serialized spec) or with the legacy boolean kwargs
    (``ratr=`` …); both normalize to the same canonical pipeline and share
    one cache entry.
    """

    def __init__(self, max_entries: int = 64):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self._cache: OrderedDict[tuple, bytes] = OrderedDict()
        # Fragment count per cached blob (parallel to _cache, which stays a
        # plain key -> bytes map — debug consumers index it directly).
        self._frags: dict[tuple, int] = {}
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # Elastic bookkeeping: rekey_for_mesh calls survived, and the mesh
        # size whose entries currently get LRU priority (None = never
        # rescaled — a fixed-mesh run).
        self.rekeyed = 0
        self.active_ep: Optional[int] = None
        # Online-tuning bookkeeping: the bucket-spec key whose entries
        # currently get LRU priority (None = no hot-swap ever happened).
        # Stored untagged (no ("ep", n) suffix) — a swap applies to every
        # mesh size's population of that policy.
        self.active_bucket: Optional[tuple] = None
        # Padded-vs-exact row accounting (reported by bucketing consumers
        # via record_rows; the cache only ever sees bucketed plans, so it
        # cannot derive the exact rows itself).
        self.exact_rows = 0
        self.padded_rows = 0
        self._step_snapshot = (0, 0, 0, 0, 0)

    @staticmethod
    def _resolve(cfg: ScheduleConfig, direction: str, pipeline,
                 opts: dict) -> tuple[ScheduleConfig, "object"]:
        """Normalize (config, pipeline) — including ``pipeline="auto"``.

        ``"auto"`` resolves through the cost-model-guided selector with the
        full ``gmm_m_split`` budget grid: the returned config may carry a
        re-tiled ``gmm_m_split``/``gmm_split_mode``, and the returned
        pipeline is the resolved spec. Resolution is deterministic and
        memoized, so an ``"auto"`` request and the equivalent explicit
        request produce the same key — one cache entry (cache-hit parity).
        """
        from .autoselect import auto_pipeline, is_auto
        if is_auto(pipeline):
            pipe, cfg = auto_pipeline(None, cfg, direction=direction)
            return cfg, pipe
        return cfg, resolve_pipeline(pipeline, **opts)

    @staticmethod
    def key(cfg: ScheduleConfig, direction: str, pipeline=None,
            **opts) -> tuple:
        # Key on the effective routing (cfg.routing), so an explicit
        # balanced plan and the equivalent scalar-rows config share one
        # entry; a fresh imbalanced router output compiles a fresh SSC.
        # ``pipeline="auto"`` is keyed by its *resolved* (config, spec) —
        # cached schedules stay byte-addressable by what actually compiled.
        cfg, pipe = SSCCache._resolve(cfg, direction, pipeline, opts)
        # Topology key + dispatch mode + compression: two-level dispatch
        # emits a different task structure (and the aggregation threshold
        # depends on the link parameters), so schedules compiled under
        # different cluster shapes must never alias.
        topo = cfg.topology.key() if cfg.topology is not None else None
        bucket = cfg.bucket
        if bucket is not None:
            # Bucket ladders are per-mesh-size populations (plan cells are
            # [ep, ep, e_loc]); the key carries the spec tagged to this
            # config's mesh so rekey_for_mesh can migrate populations
            # without guessing which mesh an entry belonged to.
            from .buckets import BucketSpec
            bucket = BucketSpec.from_any(bucket).for_mesh(cfg.ep).key()
        return (cfg.ep, cfg.e_loc, cfg.d_model, cfg.d_ff, cfg.dtype_bytes,
                cfg.gmm_m_split, cfg.gmm_split_mode, cfg.routing.counts,
                bucket, topo, cfg.dispatch_mode, cfg.xnode_compress,
                direction, pipe.key())

    def get_or_compile(self, cfg: ScheduleConfig, direction: str,
                       pipeline=None, **opts) -> Schedule:
        from .odg import build_moe_ffn_backward, build_moe_ffn_forward
        from .scheduler import compile_schedule
        cfg, pipe = self._resolve(cfg, direction, pipeline, opts)
        k = self.key(cfg, direction, pipeline=pipe)
        blob = self._cache.get(k)
        if blob is None:
            self.misses += 1
            builder = (build_moe_ffn_forward if direction == "forward"
                       else build_moe_ffn_backward)
            sched = compile_schedule(builder(cfg), pipeline=pipe)
            if cfg.bucket is not None:
                # Provenance: the blob records which quantization policy
                # shaped its plan, next to the pipeline spec that shaped
                # its queues (JSON-safe list form of BucketSpec.key()).
                from .buckets import BucketSpec
                sched.opts["bucket"] = BucketSpec.from_any(cfg.bucket).spec()
            blob = schedule_to_ssc(sched)
            self._insert(k, blob, fragments=1)
        else:
            self.hits += 1
            self._cache.move_to_end(k)
        return ssc_to_schedule(blob)

    def _insert(self, k: tuple, blob: bytes, fragments: int) -> None:
        self._cache[k] = blob
        self._frags[k] = fragments
        while len(self._cache) > self.max_entries:
            ek, _ = self._cache.popitem(last=False)
            self._frags.pop(ek, None)
            self.evictions += 1

    # -- elastic re-keying (core/elastic.py rescale path) --------------------

    @staticmethod
    def _key_ep(k: tuple) -> int:
        """Mesh size a resident key was compiled for (fused keys carry it
        in their per-layer key tuple)."""
        if k and k[0] == "fused":
            layers = k[4]
            return layers[0][0] if layers else -1
        return k[0]

    @staticmethod
    def _tag_bucket(k: tuple) -> tuple:
        """One plain key with a legacy untagged bucket field retagged to
        the key's own mesh size (no-op for tagged or bucket-less keys)."""
        b = k[8]
        if b is None or (isinstance(b[-1], tuple) and len(b[-1]) == 2
                         and b[-1][0] == "ep"):
            return k
        return k[:8] + (b + (("ep", k[0]),),) + k[9:]

    @classmethod
    def _retag_key(cls, k: tuple) -> tuple:
        if k and k[0] == "fused":
            return (k[:4] + (tuple(cls._tag_bucket(lk) for lk in k[4]),)
                    + k[5:])
        return cls._tag_bucket(k)

    def rekey_for_mesh(self, new_ep: int) -> dict:
        """Re-key — never flush — the resident population for a new mesh.

        Rank loss does not invalidate compiled schedules: an old-mesh blob
        stays bit-correct should the mesh grow back, and the new mesh's
        population fills through the normal ``get_or_compile`` path (whose
        keys lead with ``cfg.ep`` and carry ``ep``-tagged bucket specs, so
        mesh populations never alias). This method (1) retags any legacy
        untagged bucket fields in resident keys with their own mesh size,
        (2) boosts the ``new_ep`` population to the MRU end — stale-mesh
        entries bear the LRU eviction pressure first — and (3) records
        ``active_ep`` so ``info()`` reports occupancy per mesh.

        Returns ``{"entries", "active", "stale", "retagged"}`` counts.
        """
        if new_ep < 1:
            raise ValueError(f"new_ep must be >= 1, got {new_ep}")
        retagged = 0
        items = []
        for k, blob in list(self._cache.items()):
            nk = self._retag_key(k)
            if nk != k:
                retagged += 1
                self._frags[nk] = self._frags.pop(k, 1)
            items.append((nk, blob))
        self._cache = OrderedDict(items)
        # MRU-boost the new mesh's entries in their existing relative order.
        for k in [k for k in self._cache if self._key_ep(k) == new_ep]:
            self._cache.move_to_end(k)
        self.active_ep = int(new_ep)
        self.rekeyed += 1
        active = sum(1 for k in self._cache if self._key_ep(k) == new_ep)
        return {"entries": len(self._cache), "active": active,
                "stale": len(self._cache) - active, "retagged": retagged}

    # -- online bucket hot-swap (launch/online.py serving path) --------------

    @staticmethod
    def _untag_bucket_key(b) -> Optional[tuple]:
        """A key's bucket field with any trailing ``("ep", n)`` tag removed
        (the canonical policy identity, mesh-size independent)."""
        if b is None:
            return None
        b = tuple(b)
        if b and isinstance(b[-1], tuple) and len(b[-1]) == 2 \
                and b[-1][0] == "ep":
            return b[:-1]
        return b

    @classmethod
    def _key_bucket(cls, k: tuple) -> Optional[tuple]:
        """Untagged bucket policy a resident key was quantized with (fused
        keys report their first layer's — layers share a policy today)."""
        if k and k[0] == "fused":
            layers = k[4]
            return cls._untag_bucket_key(layers[0][8]) if layers else None
        return cls._untag_bucket_key(k[8])

    def rekey_for_bucket(self, spec) -> dict:
        """Hot-swap the active bucket policy — re-key, never flush.

        The serving-path twin of :meth:`rekey_for_mesh`: when the online
        tuner (``launch/online.py``) swaps the serving ``BucketSpec``, the
        incumbent policy's compiled schedules stay bit-correct (quantization
        only shapes plan *counts*; padding rows are provably inert) and the
        ladder may swap back, so nothing is invalidated. This method
        (1) boosts the new policy's resident entries to the MRU end —
        stale-policy entries bear the LRU eviction pressure first — and
        (2) records ``active_bucket`` so ``info()`` reports occupancy per
        policy. The new policy's population then fills through the normal
        ``get_or_compile`` path (``cfg.bucket`` is part of the key, so
        policies never alias even when two specs quantize one batch to the
        same counts).

        Returns ``{"entries", "active", "stale"}`` counts.
        """
        from .buckets import BucketSpec
        bk = self._untag_bucket_key(BucketSpec.from_any(spec).key())
        for k in [k for k in self._cache if self._key_bucket(k) == bk]:
            self._cache.move_to_end(k)
        self.active_bucket = bk
        self.rekeyed += 1
        active = sum(1 for k in self._cache if self._key_bucket(k) == bk)
        return {"entries": len(self._cache), "active": active,
                "stale": len(self._cache) - active}

    def get_or_compile_fused(self, cfgs, direction: str, **kw) -> Schedule:
        """Fused multi-layer twin of :meth:`get_or_compile` (the reference's
        ``SSCCache.get_or_compile_fused``); not ported yet."""
        raise NotImplementedError(_FUSION)

    def get_or_compile_pp_fused(self, cfgs, n_microbatches: int,
                                direction: str, **kw) -> Schedule:
        """PP-fused twin (the reference's
        ``SSCCache.get_or_compile_pp_fused``); not ported yet."""
        raise NotImplementedError(_FUSION)

    def record_rows(self, exact_rows: int, padded_rows: int) -> None:
        """Accumulate one bucketed plan's padded-vs-exact row accounting.

        Called by consumers that quantize plans before keying (the dropless
        bridge, the replay harness): ``exact_rows`` is the batch's routed
        row count, ``padded_rows`` the bucketed plan's total rows. The
        cumulative ratio surfaces in ``info()``/``step_stats()`` so bucket
        policies are comparable straight from the ``ssc_*`` train metrics.
        """
        if padded_rows < exact_rows:
            raise ValueError(
                f"padded_rows={padded_rows} < exact_rows={exact_rows}: "
                f"bucketed plans must cover the exact plan")
        self.exact_rows += int(exact_rows)
        self.padded_rows += int(padded_rows)

    @staticmethod
    def _pad_ratio(padded: int, exact: int) -> float:
        return padded / exact if exact else 1.0

    def info(self) -> dict:
        """Occupancy + counter snapshot (for logs and capacity planning).

        ``per_entry`` itemizes each resident blob's byte size and fragment
        count (LRU order, oldest first) — multi-fragment blobs are several
        times a per-layer blob, so capacity planning needs to see them.
        """
        return {
            "entries": len(self._cache),
            "max_entries": self.max_entries,
            "bytes": sum(len(b) for b in self._cache.values()),
            "per_entry": [{"bytes": len(b),
                           "fragments": self._frags.get(k, 1)}
                          for k, b in self._cache.items()],
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "rekeyed": self.rekeyed,
            "active_ep": self.active_ep,
            "active_bucket": self.active_bucket,
            "by_ep": dict(sorted(
                (ep, sum(1 for k in self._cache if self._key_ep(k) == ep))
                for ep in {self._key_ep(k) for k in self._cache})),
            "by_bucket": {
                str(b): n for b, n in sorted(
                    ((b, sum(1 for k in self._cache
                             if self._key_bucket(k) == b))
                     for b in {self._key_bucket(k) for k in self._cache}),
                    key=lambda kv: str(kv[0]))},
            "exact_rows": self.exact_rows,
            "padded_rows": self.padded_rows,
            "pad_ratio": self._pad_ratio(self.padded_rows, self.exact_rows),
        }

    def step_stats(self) -> dict:
        """Hit/miss/eviction *deltas* since the previous call, + occupancy.

        The dropless training step calls this once per executed step to
        surface per-step recompile counts in its metrics dict; ``misses``
        is the number of schedules compiled during the step (0 on a fully
        cache-served step). ``pad_ratio`` is the padded-vs-exact row ratio
        of the plans recorded *during the step* (1.0 when none were).
        """
        cur = (self.hits, self.misses, self.evictions,
               self.exact_rows, self.padded_rows)
        last = self._step_snapshot
        self._step_snapshot = cur
        return {
            "hits": cur[0] - last[0],
            "misses": cur[1] - last[1],
            "evictions": cur[2] - last[2],
            "entries": len(self._cache),
            "pad_ratio": self._pad_ratio(cur[4] - last[4], cur[3] - last[3]),
        }
