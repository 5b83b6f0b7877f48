"""The port's copy of the schedule compiler and simulator
(``repro_torch.core``) against the JAX package's (``repro.core``).

Both are pure Python and numpy with the same arithmetic and iteration order,
so the same graph must compile to the same taskflow — every task's fields,
the events, the queue orders and ``opts`` — and price to the same
``SimResult``, exactly, not within a tolerance. Each package builds its own
configs and plans from its own classes; only plain values are compared.
"""

import dataclasses
import importlib
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
MODULES = ("autoselect", "buckets", "hardware", "odg", "passes", "routing",
           "scheduler", "simulator")


def _pkg(root: str) -> types.SimpleNamespace:
    return types.SimpleNamespace(**{
        m: importlib.import_module(f"{root}.core.{m}") for m in MODULES})


J, T = _pkg("repro"), _pkg("repro_torch")
PIPELINES = (*J.passes.SCHED_PIPELINES, "auto")
PLANS = ("balanced", "skewed", "hotspot")


def _plan(P, name: str, ep: int = 4, e_loc: int = 2, rows: int = 6):
    R = P.routing
    if name == "balanced":
        return R.balanced_plan(ep, e_loc, rows)
    if name == "skewed":
        return R.skewed_plan(ep, e_loc, rows, 1.5)
    if name == "hotspot":
        return R.hotspot_plan(ep, e_loc, rows, background=1)
    if name == "node_limited":
        return R.node_limited_plan(ep, e_loc, rows, node_size=4)
    if name == "random":
        return R.random_plan(ep, e_loc, rows, np.random.default_rng(3),
                             p_zero=0.4)
    raise KeyError(name)


def _cfg(P, plan, **kw):
    base = dict(ep=plan.ep, e_loc=plan.e_loc, rows=0, d_model=64, d_ff=32,
                plan=plan, gmm_m_split=2, gmm_split_mode="source_aligned")
    base.update(kw)
    return P.odg.ScheduleConfig(**base)


def _pipeline(P, name):
    return "auto" if name == "auto" else P.passes.SCHED_PIPELINES[name]


def _compile_moe(P, direction, pipeline, cfg):
    build = (P.odg.build_moe_ffn_forward if direction == "forward"
             else P.odg.build_moe_ffn_backward)
    return P.scheduler.compile_schedule(build(cfg), pipeline=pipeline)


def _assert_same_schedule(a, b):
    assert (a.direction, a.ep, a.n_tasks) == (b.direction, b.ep, b.n_tasks)
    for ta, tb in zip(a.tasks, b.tasks):
        assert dataclasses.asdict(ta) == dataclasses.asdict(tb)
    assert ({k: dataclasses.asdict(e) for k, e in a.events.items()}
            == {k: dataclasses.asdict(e) for k, e in b.events.items()})
    assert list(a.queues.items()) == list(b.queues.items())
    assert a.opts == b.opts


def _assert_same_sim(a, b):
    """Both simulators, field for field (makespans, busy clocks, L2 hits,
    the whole timeline)."""
    for fn in ("simulate_baseline", "simulate_unified"):
        ra = getattr(J.simulator, fn)(a, J.hardware.AscendA3())
        rb = getattr(T.simulator, fn)(b, T.hardware.AscendA3())
        assert dataclasses.asdict(ra) == dataclasses.asdict(rb), fn


@pytest.mark.parametrize("pipeline", PIPELINES)
@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("plan", PLANS)
def test_moe_ffn_schedule_and_sim_equal(plan, direction, pipeline):
    """MoE FFN at ep=4 under every named pipeline and ``"auto"``."""
    a = _compile_moe(J, direction, _pipeline(J, pipeline),
                     _cfg(J, _plan(J, plan)))
    b = _compile_moe(T, direction, _pipeline(T, pipeline),
                     _cfg(T, _plan(T, plan)))
    _assert_same_schedule(a, b)
    _assert_same_sim(a, b)


@pytest.mark.parametrize("pipeline", [(), ("hier_dispatch",),
                                      ("ratr", "hier_dispatch"), "auto"])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_two_node_hier_dispatch_equal(direction, pipeline):
    """Two nodes of two ranks, two-level dispatch with the int8 cross-node
    hop: runs the compiler's and the selector's lazy imports of
    ``int8_wire_bytes``."""
    def cfg(P):
        return _cfg(P, _plan(P, "skewed"),
                    topology=P.hardware.Topology(ranks_per_node=2),
                    dispatch_mode="hier", xnode_compress="int8")
    a = _compile_moe(J, direction, pipeline, cfg(J))
    b = _compile_moe(T, direction, pipeline, cfg(T))
    assert any(t.op_type == "dispatch_xnode" for t in b.tasks)
    _assert_same_schedule(a, b)
    _assert_same_sim(a, b)


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_bucketed_config_equal(direction):
    """A plan quantized by a geometric BucketSpec, with the spec's key in
    the config."""
    def cfg(P):
        spec = P.buckets.BucketSpec.geometric(2)
        return _cfg(P, spec.apply(_plan(P, "hotspot")), bucket=spec)
    a = _compile_moe(J, direction, "ratr", cfg(J))
    b = _compile_moe(T, direction, "ratr", cfg(T))
    assert cfg(T).bucket == cfg(J).bucket is not None
    _assert_same_schedule(a, b)
    _assert_same_sim(a, b)


def _jax_swiglu_add_odg(M, n_tiles):
    """The reference benchmark's §6 graph (``benchmarks/common.py``)."""
    spec = importlib.util.spec_from_file_location(
        "_bench_common", REPO / "benchmarks" / "common.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build_swiglu_add_odg(M, n_tiles)


@pytest.mark.parametrize("pipeline", [None, ["chain_interleave"]])
def test_swiglu_add_schedule_and_sim_equal(pipeline):
    """The §6 SwiGLU → Add graph at M = 8192 in 64 tiles."""
    from repro_torch.launch.bench_swiglu_add import build_swiglu_add_odg
    a = J.scheduler.compile_schedule(_jax_swiglu_add_odg(8192, 64),
                                     pipeline=pipeline)
    b = T.scheduler.compile_schedule(build_swiglu_add_odg(8192, 64),
                                     pipeline=pipeline)
    _assert_same_schedule(a, b)
    _assert_same_sim(a, b)


def test_benchmark_sim_rows_equal_the_reference():
    """The port's §6.1 rows against the reference benchmark's arithmetic
    (``benchmarks/bench_swiglu_add.py``: serial through
    ``simulate_baseline``, ``chain_interleave`` through
    ``simulate_unified``, M // 128 tiles), computed here by the JAX
    package."""
    from repro_torch.launch.bench_swiglu_add import SIM_SIZES, sim_rows
    hw = J.hardware.AscendA3()
    want = []
    for M in SIM_SIZES:
        ser = J.simulator.simulate_baseline(J.scheduler.compile_schedule(
            _jax_swiglu_add_odg(M, M // 128)), hw)
        inter = J.simulator.simulate_unified(J.scheduler.compile_schedule(
            _jax_swiglu_add_odg(M, M // 128),
            pipeline=["chain_interleave"]), hw)
        want.append({"M": M, "serial_us": ser.makespan_us,
                     "interleaved_us": inter.makespan_us,
                     "l2_hit_serial": ser.l2_hit_rate,
                     "l2_hit_inter": inter.l2_hit_rate})
    assert sim_rows() == want
    assert want[-1]["serial_us"] > want[-1]["interleaved_us"]


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("plan", ["balanced", "skewed", "hotspot",
                                  "node_limited", "random"])
def test_auto_pipeline_picks_the_same(plan, direction):
    """The selector at ep=8 with its full retiling grid: the same pick,
    config and every candidate's predicted time."""
    def choice(P):
        p = _plan(P, plan, ep=8, e_loc=4, rows=12)
        return P.autoselect.select(p, _cfg(P, p, gmm_m_split=4),
                                   direction=direction)
    a, b = choice(J), choice(T)
    assert a.pipeline.spec() == b.pipeline.spec()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    pa, ca = J.autoselect.auto_pipeline(None, a.cfg, direction=direction)
    pb, cb = T.autoselect.auto_pipeline(None, b.cfg, direction=direction)
    assert pa.spec() == pb.spec()
    assert dataclasses.asdict(ca) == dataclasses.asdict(cb)
