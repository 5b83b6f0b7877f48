"""The port's SSC cache (``repro_torch.core.ssc``) against the JAX package's
(``repro.core.ssc``).

The port serializes with JSON where the reference uses msgpack, so blob
bytes differ; what must not differ is everything a consumer sees: the cache
key of a request, the decoded schedule, the hit/miss/eviction sequence, the
LRU order and the per-step deltas. Each package builds its own configs and
plans from its own classes and the same numbers; only plain values are
compared, exactly.
"""

import dataclasses
import importlib
import json
import types

import numpy as np
import pytest

pytest.importorskip("torch")

MODULES = ("buckets", "hardware", "odg", "routing", "scheduler", "ssc")


def _pkg(root: str) -> types.SimpleNamespace:
    ns = types.SimpleNamespace(**{
        m: importlib.import_module(f"{root}.core.{m}") for m in MODULES})
    ns.moe = importlib.import_module(f"{root}.models.moe")
    return ns


J, T = _pkg("repro"), _pkg("repro_torch")
PKGS = {"jax": J, "port": T}


def _plan(P, name: str):
    """The plans of ``tests/test_routing_exec.py`` and a dropless plan
    bucketed from a routed batch."""
    R = P.routing
    if name == "skewed":
        return R.skewed_plan(3, 2, 6, 1.5)
    if name == "sparse":
        return R.random_plan(3, 2, 7, np.random.default_rng(42), p_zero=0.5)
    if name == "hotspot":
        return R.hotspot_plan(3, 2, 4)
    if name == "one_empty_src":
        return R.RoutingPlan.from_counts(
            [[[0, 0], [0, 0], [0, 0]],
             [[5, 1], [0, 2], [3, 0]],
             [[2, 0], [4, 4], [0, 1]]])
    raise KeyError(name)


def _routed_top_i(seed=0, T_=64, E=8, k=2):
    return np.random.default_rng(seed).integers(0, E, size=(T_, k))


def _dropless_cfg(P, bucket="geometric:8", ep=4, seed=0):
    mc = P.moe.MoEConfig(n_experts=8, top_k=2, d_expert=8)
    spec = P.buckets.BucketSpec.from_any(bucket)
    bridge = P.moe.plan_from_routing(_routed_top_i(seed), mc, ep,
                                     capacity=None, bucket=spec)
    return P.odg.ScheduleConfig(ep=ep, e_loc=bridge.plan.e_loc, rows=0,
                                d_model=16, d_ff=8, plan=bridge.plan,
                                gmm_split_mode="source_aligned",
                                bucket=spec.key())


def _cfg(P, case: str):
    if case == "balanced_m3":        # tests/test_executor.py's CFG
        return P.odg.ScheduleConfig(ep=3, e_loc=2, rows=4, d_model=24,
                                    d_ff=12, gmm_m_split=3)
    if case == "dropless_geometric":
        return _dropless_cfg(P, "geometric:8")
    if case == "dropless_linear16":
        return _dropless_cfg(P, 16, ep=2, seed=1)
    if case == "hier_int8":
        return P.odg.ScheduleConfig(
            ep=4, e_loc=2, rows=0, d_model=16, d_ff=8,
            plan=P.routing.skewed_plan(4, 2, 6, 1.5),
            topology=P.hardware.Topology(ranks_per_node=2),
            dispatch_mode="hier", xnode_compress="int8",
            gmm_split_mode="source_aligned")
    plan = _plan(P, case)
    return P.odg.ScheduleConfig(ep=plan.ep, e_loc=plan.e_loc, rows=0,
                                d_model=8, d_ff=4, plan=plan)


CASES = ("balanced_m3", "skewed", "sparse", "hotspot", "one_empty_src",
         "dropless_geometric", "dropless_linear16", "hier_int8")
PIPELINES = (["ratr"], ["ratr", "gmm_interleave"], [], "auto")


def _plain(s) -> dict:
    """A decoded schedule as plain values: every field a consumer reads."""
    return {"direction": s.direction, "ep": s.ep,
            "tasks": [dataclasses.asdict(t) for t in s.tasks],
            "events": {k: dataclasses.asdict(e) for k, e in s.events.items()},
            "queues": list(s.queues.items()), "opts": s.opts}


@pytest.mark.parametrize("pipeline", PIPELINES, ids=str)
@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("case", CASES)
def test_key_and_decoded_schedule_equal_jax(case, direction, pipeline):
    """The cache key equals the reference's, the schedule the cache hands
    back equals the reference's decoded one, and the port's blob decodes to
    exactly the schedule it encoded."""
    jc, tc = J.ssc.SSCCache(), T.ssc.SSCCache()
    jcfg, tcfg = _cfg(J, case), _cfg(T, case)
    if case == "hier_int8" and pipeline != "auto":
        pipeline = pipeline + ["hier_dispatch"]     # two-level dispatch
    assert T.ssc.SSCCache.key(tcfg, direction, pipeline=pipeline) == \
        J.ssc.SSCCache.key(jcfg, direction, pipeline=pipeline)
    a = jc.get_or_compile(jcfg, direction, pipeline=pipeline)
    b = tc.get_or_compile(tcfg, direction, pipeline=pipeline)
    assert _plain(b) == _plain(a)
    assert list(tc._cache) == list(jc._cache)
    blob = next(iter(tc._cache.values()))
    assert json.loads(blob)["version"] == 1
    again = T.ssc.ssc_to_schedule(T.ssc.schedule_to_ssc(b))
    assert _plain(again) == _plain(b)
    # A second request is a hit in both and decodes to the same schedule.
    assert _plain(tc.get_or_compile(tcfg, direction, pipeline=pipeline)) \
        == _plain(b)
    jc.get_or_compile(jcfg, direction, pipeline=pipeline)
    assert (tc.hits, tc.misses) == (jc.hits, jc.misses) == (1, 1)


def test_legacy_flags_and_pipeline_share_an_entry():
    for P in (J, T):
        c = P.ssc.SSCCache()
        cfg = _cfg(P, "skewed")
        c.get_or_compile(cfg, "backward", ratr=True, gmm_interleave=True)
        c.get_or_compile(cfg, "backward",
                         pipeline=["ratr", "gmm_interleave"])
        assert (c.hits, c.misses, c.info()["entries"]) == (1, 1, 1)


def _fetch(P, cache, plan, direction="forward"):
    cfg = P.odg.ScheduleConfig(ep=plan.ep, e_loc=plan.e_loc, rows=0,
                               d_model=16, d_ff=8, plan=plan)
    cache.get_or_compile(cfg, direction, pipeline=["ratr"])


def _counters(c) -> dict:
    info = c.info()
    return {k: info[k] for k in ("entries", "max_entries", "hits", "misses",
                                 "evictions", "rekeyed", "active_ep",
                                 "active_bucket", "by_ep", "by_bucket",
                                 "exact_rows", "padded_rows", "pad_ratio")}


@pytest.mark.parametrize("bucket", [1, 8])
def test_hits_repeated_and_bucketed_jitter_equal_jax(bucket):
    """The sequence of ``test_cache_hits_repeated_and_bucketed_jitter``:
    counters after every request and the step deltas equal the
    reference's."""
    base = np.concatenate([np.repeat(np.arange(4), 4)[:, None]] * 2, axis=0)
    jit_ = base.copy()
    jit_[0, 0] = 1
    caches = {n: P.ssc.SSCCache(max_entries=8) for n, P in PKGS.items()}
    for ti in (base, base, jit_):
        for n, c in caches.items():
            P = PKGS[n]
            mc = P.moe.MoEConfig(n_experts=4, top_k=1, d_expert=8)
            bridge = P.moe.plan_from_routing(ti, mc, 2, capacity=None,
                                             bucket=bucket)
            c.record_rows(int(bridge.send_row.size), bridge.plan.total_rows)
            _fetch(P, c, bridge.plan)
        assert _counters(caches["port"]) == _counters(caches["jax"])
        assert list(caches["port"]._cache) == list(caches["jax"]._cache)
    want = {1: (1, 2), 8: (2, 1)}[bucket]
    assert (caches["port"].hits, caches["port"].misses) == want
    for _ in range(2):
        assert caches["port"].step_stats() == caches["jax"].step_stats()


def test_lru_order_and_evictions_equal_jax():
    """A bound of 3 entries under 8 requests over 5 plans: the same
    evictions, in the same LRU order, as the reference."""
    caches = {n: P.ssc.SSCCache(max_entries=3) for n, P in PKGS.items()}
    for i in (0, 1, 2, 0, 3, 4, 1, 0):
        for n, c in caches.items():
            P = PKGS[n]
            plan = P.routing.skewed_plan(2, 2, 3 + i, 1.5)
            _fetch(P, c, plan)
        assert list(caches["port"]._cache) == list(caches["jax"]._cache)
        assert _counters(caches["port"]) == _counters(caches["jax"])
        assert caches["port"].step_stats() == caches["jax"].step_stats()
    assert caches["port"].evictions == 4


def test_rekey_for_mesh_and_bucket_equal_jax():
    """Two mesh sizes and two bucket policies resident: re-keying for a
    mesh, then for a policy, moves the same entries to the MRU end and
    reports the same counts as the reference."""
    caches = {n: P.ssc.SSCCache(max_entries=16) for n, P in PKGS.items()}
    for n, c in caches.items():
        P = PKGS[n]
        for ep, bucket, seed in ((2, "geometric:8", 0), (4, 8, 1),
                                 (2, 8, 2), (4, "geometric:8", 3)):
            c.get_or_compile(_dropless_cfg(P, bucket, ep, seed), "forward",
                             pipeline=["ratr"])
    for step in ("mesh2", "bucket8", "mesh4"):
        out = {}
        for n, c in caches.items():
            P = PKGS[n]
            if step.startswith("mesh"):
                out[n] = c.rekey_for_mesh(int(step[-1]))
            else:
                out[n] = c.rekey_for_bucket(
                    P.buckets.BucketSpec.from_any(8))
        assert out["port"] == out["jax"]
        assert list(caches["port"]._cache) == list(caches["jax"]._cache)
        assert _counters(caches["port"]) == _counters(caches["jax"])
    with pytest.raises(ValueError):
        caches["port"].rekey_for_mesh(0)


def test_max_entries_must_be_positive():
    with pytest.raises(ValueError):
        T.ssc.SSCCache(max_entries=0)


def test_record_rows_refuses_a_plan_smaller_than_its_routing():
    c = T.ssc.SSCCache()
    c.record_rows(10, 16)
    with pytest.raises(ValueError, match="cover"):
        c.record_rows(10, 9)
    assert c.info()["pad_ratio"] == 1.6


def test_fused_schedules_wait_for_the_fusion_slice():
    c = T.ssc.SSCCache()
    cfg = _cfg(T, "skewed")
    with pytest.raises(NotImplementedError, match="fusion"):
        c.get_or_compile_fused([cfg, cfg], "forward")
    with pytest.raises(NotImplementedError, match="fusion"):
        c.get_or_compile_pp_fused([cfg, cfg], 2, "forward")
    s = c.get_or_compile(cfg, "forward")
    blob = json.loads(T.ssc.schedule_to_ssc(s))
    blob["fragments"] = [{"index": 0}]
    with pytest.raises(NotImplementedError, match="fusion"):
        T.ssc.ssc_to_schedule(json.dumps(blob).encode())


def test_rank_view_and_dump_json_equal_jax(tmp_path):
    a = J.ssc.SSCCache().get_or_compile(_cfg(J, "hotspot"), "forward",
                                        pipeline=["ratr"])
    b = T.ssc.SSCCache().get_or_compile(_cfg(T, "hotspot"), "forward",
                                        pipeline=["ratr"])
    for r in range(3):
        assert T.ssc.rank_view(b, r) == J.ssc.rank_view(a, r)
    J.ssc.dump_json(a, tmp_path / "j.json")
    T.ssc.dump_json(b, tmp_path / "t.json")
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()
