"""The port's executor (``repro_torch.core.executor``) against the JAX
package's (``repro.core.executor``), on the CPU.

Both compile the same schedule (``tests/test_torch_schedule.py`` holds the
compilers equal) and walk it with the same ``numpy.random.Generator``, so
the task order must be equal, not close. The numbers are held within
1e-5: the port's GMM tiles run the ``gmm`` wrapper (on a CPU tensor its
plain version, ``torch.bmm``), the reference's numpy matmul. Inside the
port, the executor equals its own ``*_plan`` references bit for bit at
``gmm_m_split=1``, where both make the same ``gmm`` calls.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import executor as jex  # noqa: E402
from repro.core import odg as jodg  # noqa: E402
from repro.core import routing as jrouting  # noqa: E402
from repro.core.hardware import Topology as JTopology  # noqa: E402
from repro.core.scheduler import compile_schedule as jcompile  # noqa: E402
from repro.parallel.compression import int8_roundtrip_np  # noqa: E402
from repro_torch.core import executor as tex  # noqa: E402
from repro_torch.core import odg as todg  # noqa: E402
from repro_torch.core import routing as trouting  # noqa: E402
from repro_torch.core.hardware import Topology as TTopology  # noqa: E402
from repro_torch.core.scheduler import (ScheduleError,  # noqa: E402
                                        compile_schedule as tcompile)
from repro_torch.parallel.compression import int8_roundtrip  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
TOL = dict(rtol=1e-5, atol=1e-5)
PKG = {"jax": (jodg, jrouting, jcompile, jex, JTopology),
       "port": (todg, trouting, tcompile, tex, TTopology)}


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _plan(routing, name):
    if name == "balanced":
        return None
    if name == "skewed":
        return routing.skewed_plan(3, 2, 6, 1.5)
    if name == "sparse":
        return routing.random_plan(3, 2, 7, np.random.default_rng(42),
                                   p_zero=0.5)
    if name == "hotspot":
        return routing.hotspot_plan(3, 2, 4)
    if name == "one_empty_src":
        return routing.RoutingPlan.from_counts(
            [[[0, 0], [0, 0], [0, 0]],
             [[5, 1], [0, 2], [3, 0]],
             [[2, 0], [4, 4], [0, 1]]])
    raise KeyError(name)


def _cpu(pkg):
    """The port's executor defaults to the card: its CPU runs ask for the
    CPU. The JAX executor takes no device."""
    return {"device": "cpu"} if pkg == "port" else {}


def _cfg(pkg, plan_name, m_split=1, **kw):
    odg, routing, *_ = PKG[pkg]
    plan = _plan(routing, plan_name)
    if plan is None:              # tests/test_executor.py's balanced CFG
        return odg.ScheduleConfig(ep=3, e_loc=2, rows=4, d_model=24,
                                  d_ff=12, gmm_m_split=m_split, **kw)
    return odg.ScheduleConfig(ep=plan.ep, e_loc=plan.e_loc, rows=0,
                              d_model=8, d_ff=4, plan=plan,
                              gmm_m_split=m_split,
                              gmm_split_mode="source_aligned", **kw)


def _sched(pkg, cfg, direction, pipeline):
    odg, _, compile_schedule, *_ = PKG[pkg]
    build = (odg.build_moe_ffn_forward if direction == "forward"
             else odg.build_moe_ffn_backward)
    return compile_schedule(build(cfg), pipeline=pipeline)


def _forward(pkg, plan_name, m_split, pipeline, seed, **kw):
    """Run the forward schedule; returns (state, inputs, task order)."""
    ex = PKG[pkg][3]
    cfg = _cfg(pkg, plan_name, m_split, **kw)
    s = _sched(pkg, cfg, "forward", pipeline)
    x_src, w1, w2 = ex.make_inputs_plan(cfg, 7, **_cpu(pkg))
    st = ex.ExecutorState(cfg, **_cpu(pkg))
    ex.load_forward_state_plan(cfg, st, x_src, w1, w2)
    order = []
    ex.execute(s, st, rng=np.random.default_rng(seed), record_order=order)
    return cfg, st, (x_src, w1, w2), order


def _backward(pkg, plan_name, m_split, pipeline, seed):
    """Run the backward schedule on the reference forward's activations."""
    ex = PKG[pkg][3]
    cfg = _cfg(pkg, plan_name, m_split)
    s = _sched(pkg, cfg, "backward", pipeline)
    x_src, w1, w2 = ex.make_inputs_plan(cfg, 11, **_cpu(pkg))
    fwd = ex.reference_forward_plan(cfg, x_src, w1, w2)
    rng = np.random.default_rng(seed + 100)
    dy = [rng.standard_normal(tuple(fwd["y_ret"][r].shape)).astype(
        np.float32) for r in range(cfg.ep)]
    if pkg == "port":
        dy = [torch.from_numpy(a) for a in dy]
    st = ex.ExecutorState(cfg, **_cpu(pkg))
    ex.load_backward_state_plan(cfg, st, fwd, w1, w2, dy)
    order = []
    ex.execute(s, st, rng=np.random.default_rng(seed), record_order=order)
    return cfg, st, (x_src, w1, w2, fwd, dy), order


def _ranked(cfg, st, name, rows_of):
    return [_np(st.get(name, r)) for r in range(cfg.ep)
            if rows_of(r)]


PLANS = ("balanced", "skewed", "sparse", "hotspot", "one_empty_src")
FWD_PIPES = ([], ["ratr"])
BWD_PIPES = (["ratr"], ["ratr", "gmm_interleave"])


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("pipeline", FWD_PIPES, ids=str)
@pytest.mark.parametrize("m_split", [1, 3])
@pytest.mark.parametrize("plan", PLANS)
def test_forward_matches_jax(plan, m_split, pipeline, seed):
    """Every buffer of the forward, within 1e-5, and the same task order;
    ``ratr`` on and off, ``gmm_m_split`` 1 and 3."""
    jc, jst, _, jorder = _forward("jax", plan, m_split, pipeline, seed)
    tc, tst, _, torder = _forward("port", plan, m_split, pipeline, seed)
    assert torder == jorder
    plan_ = tc.routing
    for name, rows_of in (("x_recv", plan_.recv_rows),
                          ("h", plan_.recv_rows), ("g", plan_.recv_rows),
                          ("y", plan_.recv_rows),
                          ("y_ret", plan_.send_rows)):
        for a, b in zip(_ranked(tc, tst, name, rows_of),
                        _ranked(jc, jst, name, rows_of)):
            np.testing.assert_allclose(a, b, **TOL, err_msg=name)
    assert set(tst.buffers) == set(jst.buffers)
    for key, buf in jst.buffers.items():
        assert tuple(tst.buffers[key].shape) == buf.shape, key


@pytest.mark.parametrize("pipeline", BWD_PIPES, ids=str)
@pytest.mark.parametrize("m_split", [1, 3])
@pytest.mark.parametrize("plan", PLANS)
def test_backward_matches_jax(plan, m_split, pipeline):
    jc, jst, _, jorder = _backward("jax", plan, m_split, pipeline, 3)
    tc, tst, _, torder = _backward("port", plan, m_split, pipeline, 3)
    assert torder == jorder
    p = tc.routing
    for name, rows_of in (("dx_ret", p.send_rows), ("dW1", p.recv_rows),
                          ("dW2", p.recv_rows), ("dy_recv", p.recv_rows)):
        for a, b in zip(_ranked(tc, tst, name, rows_of),
                        _ranked(jc, jst, name, rows_of)):
            np.testing.assert_allclose(a, b, **TOL, err_msg=name)


@pytest.mark.parametrize("plan", PLANS)
def test_executor_equals_own_references_bit_for_bit(plan):
    """At ``gmm_m_split=1`` the tiles and the ``*_plan`` references make the
    same ``gmm`` calls: forward and backward are bit-equal, and the
    backward is within 1e-5 of the autograd oracle and of the reference's
    ``reference_backward_plan``."""
    cfg, st, (x_src, w1, w2), _ = _forward("port", plan, 1, ["ratr"], 1)
    ref = tex.reference_forward_plan(cfg, x_src, w1, w2)
    p = cfg.routing
    for r in range(cfg.ep):
        if p.send_rows(r):
            assert torch.equal(st.get("y_ret", r), ref["y_ret"][r])
        if p.recv_rows(r):
            for name in ("x_recv", "h", "g", "y"):
                assert torch.equal(st.get(name, r), ref[name][r]), name
    cfg, st, (x_src, w1, w2, fwd, dy), _ = _backward(
        "port", plan, 1, ["ratr", "gmm_interleave"], 0)
    dx, dw1, dw2 = tex.reference_backward_plan(cfg, fwd, w1, w2, dy)
    ax, aw1, aw2 = tex.reference_backward_plan_autograd(cfg, x_src, w1, w2,
                                                        dy)
    jc, jst, (jx, jw1, jw2, jfwd, jdy), _ = _backward(
        "jax", plan, 1, ["ratr", "gmm_interleave"], 0)
    jdx, jdw1, jdw2 = jex.reference_backward_plan(jc, jfwd, jw1, jw2, jdy)
    for r in range(cfg.ep):
        if p.send_rows(r):
            assert torch.equal(st.get("dx_ret", r), dx[r])
            np.testing.assert_allclose(_np(ax[r]), _np(dx[r]), **TOL)
            np.testing.assert_allclose(_np(dx[r]), jdx[r], **TOL)
        if p.recv_rows(r):
            assert torch.equal(st.get("dW1", r), dw1[r])
            assert torch.equal(st.get("dW2", r), dw2[r])
    for got, oracle, jref in ((dw1, aw1, jdw1), (dw2, aw2, jdw2)):
        np.testing.assert_allclose(_np(oracle), _np(got), **TOL)
        np.testing.assert_allclose(_np(got), jref, **TOL)


@pytest.mark.parametrize("interleave", [False, True])
def test_balanced_backward_matches_autograd(interleave):
    """The balanced fragment's backward against ``torch.autograd`` of the
    monolithic reference (the reference's ``jax.vjp`` test)."""
    cfg = _cfg("port", "balanced", 3)
    s = tcompile(todg.build_moe_ffn_backward(cfg), ratr=True,
                 gmm_interleave=interleave)
    x_src, w1, w2 = tex.make_inputs(cfg, 0, device="cpu")
    fwd = tex.reference_forward(cfg, x_src, w1, w2)
    dy = torch.from_numpy(np.random.default_rng(7).standard_normal(
        tuple(fwd["y_ret"].shape)).astype(np.float32))
    st = tex.ExecutorState(cfg, device="cpu")
    tex.load_backward_state(cfg, st, fwd, w1, w2, dy)
    tex.execute(s, st, rng=np.random.default_rng(3))
    want = tex.reference_backward(cfg, x_src, w1, w2, dy)
    for name, w in zip(("dx_ret", "dW1", "dW2"), want):
        got = torch.stack([st.get(name, r) for r in range(cfg.ep)])
        np.testing.assert_allclose(_np(got), _np(w), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    jx, jw1, jw2 = jex.make_inputs(_cfg("jax", "balanced", 3), 0)
    np.testing.assert_array_equal(_np(x_src), jx)
    np.testing.assert_array_equal(_np(w2), jw2)


def test_balanced_forward_reference_matches_jax():
    tcfg, jcfg = _cfg("port", "balanced"), _cfg("jax", "balanced")
    got = tex.reference_forward(tcfg, *tex.make_inputs(tcfg, 2,
                                                       device="cpu"))
    want = jex.reference_forward(jcfg, *jex.make_inputs(jcfg, 2))
    for k in want:
        np.testing.assert_allclose(_np(got[k]), want[k], **TOL, err_msg=k)


def test_hier_int8_dispatch_matches_jax():
    """Two-level dispatch with the int8 cross-node hop: the quantized
    payload and everything after it equal the reference's."""
    out = {}
    for pkg in PKG:
        topo = PKG[pkg][4](ranks_per_node=2)
        odg, routing, compile_schedule, ex, _ = PKG[pkg]
        plan = routing.skewed_plan(4, 2, 6, 1.6)
        cfg = odg.ScheduleConfig(ep=4, e_loc=2, rows=0, d_model=8, d_ff=4,
                                 plan=plan, topology=topo,
                                 dispatch_mode="hier", xnode_compress="int8",
                                 gmm_split_mode="source_aligned")
        s = compile_schedule(odg.build_moe_ffn_forward(cfg),
                             pipeline=["ratr", "hier_dispatch"])
        assert any(t.meta.get("compress") == "int8" for t in s.tasks)
        x_src, w1, w2 = ex.make_inputs_plan(cfg, 7, **_cpu(pkg))
        st = ex.ExecutorState(cfg, **_cpu(pkg))
        ex.load_forward_state_plan(cfg, st, x_src, w1, w2)
        order = []
        ex.execute(s, st, rng=np.random.default_rng(3), record_order=order)
        out[pkg] = (plan, st, order)
    plan, tst, torder = out["port"]
    _, jst, jorder = out["jax"]
    assert torder == jorder
    for r in range(4):
        if plan.recv_rows(r):
            np.testing.assert_array_equal(_np(tst.get("x_recv", r)),
                                          jst.get("x_recv", r))
        if plan.send_rows(r):
            np.testing.assert_allclose(_np(tst.get("y_ret", r)),
                                       jst.get("y_ret", r), **TOL)


@pytest.mark.parametrize("seed", range(4))
def test_int8_roundtrip_bit_equal_numpy(seed):
    rng = np.random.default_rng(seed)
    for rows in (0, 1, 17):
        x = (rng.standard_normal((rows, 9))
             * 10.0 ** rng.integers(-4, 4)).astype(np.float32)
        got = int8_roundtrip(torch.from_numpy(x))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), int8_roundtrip_np(x))
    zeros = np.zeros((3, 4), np.float32)
    np.testing.assert_array_equal(
        int8_roundtrip(torch.from_numpy(zeros)).numpy(),
        int8_roundtrip_np(zeros))


def test_swiglu_and_grad_match_numpy():
    rng = np.random.default_rng(0)
    h = rng.standard_normal((6, 8)).astype(np.float32)
    dg = rng.standard_normal((6, 4)).astype(np.float32)
    np.testing.assert_allclose(tex.swiglu(torch.from_numpy(h)).numpy(),
                               jex.swiglu_np(h), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        tex.swiglu_grad(torch.from_numpy(dg), torch.from_numpy(h)).numpy(),
        jex.swiglu_grad_np(dg, h), rtol=1e-6, atol=1e-7)
    ht = torch.from_numpy(h).requires_grad_(True)
    f = torch.nn.functional
    (f.silu(ht[:, :4]) * ht[:, 4:]).backward(torch.from_numpy(dg))
    np.testing.assert_allclose(
        tex.swiglu_grad(torch.from_numpy(dg), torch.from_numpy(h)).numpy(),
        ht.grad.numpy(), rtol=1e-5, atol=1e-6)


def test_buffers_sized_from_rows_map():
    """Per-rank row counts differ: each lazily created buffer gets exactly
    the extent the schedule writes."""
    plan = trouting.RoutingPlan.from_counts(
        [[[9, 1], [2, 0]], [[0, 3], [1, 1]]])
    cfg = todg.ScheduleConfig(ep=2, e_loc=2, rows=0, d_model=8, d_ff=4,
                              plan=plan)
    s = tcompile(todg.build_moe_ffn_forward(cfg))
    x_src, w1, w2 = tex.make_inputs_plan(cfg, 0, device="cpu")
    st = tex.ExecutorState(cfg, device="cpu")
    tex.load_forward_state_plan(cfg, st, x_src, w1, w2)
    tex.execute(s, st, rng=np.random.default_rng(1))
    assert st.get("x_recv", 0).shape[0] == 13
    assert st.get("x_recv", 1).shape[0] == 4
    for (name, rank), rows in st.rows_map.items():
        if (name, rank) in st.buffers:
            assert st.buffers[(name, rank)].shape[0] == rows, (name, rank)


def test_plain_gmm_state_and_bad_tiles():
    """``ExecutorState(gmm=...)`` swaps the tile body (the plain executor
    the card's checks compare against); a tile range running backwards is a
    schedule error, not an empty product."""
    from repro_torch.kernels.ref import gmm_ref
    cfg, st, (x_src, w1, w2), _ = _forward("port", "hotspot", 1, [], 0)
    calls = []

    def counting(x, w):
        calls.append(tuple(x.shape))
        return gmm_ref(x, w)

    plain = tex.ExecutorState(cfg, device="cpu", gmm=counting)
    tex.load_forward_state_plan(cfg, plain, x_src, w1, w2)
    tex.execute(_sched("port", cfg, "forward", []), plain,
                rng=np.random.default_rng(0))
    assert calls and all(c[0] == 1 for c in calls)
    for r in range(cfg.ep):
        if cfg.routing.send_rows(r):
            assert torch.equal(plain.get("y_ret", r), st.get("y_ret", r))
    cfg = _cfg("port", "hotspot", 3)
    td = next(t for t in _sched("port", cfg, "forward", []).tasks
              if t.task_type == "GMM" and not t.meta.get("fallback"))
    bad = tex.ExecutorState(cfg, device="cpu")
    tex.load_forward_state_plan(cfg, bad, x_src, w1, w2)
    bad.ensure(td.inputs[0].tensor, td.inputs[0].rank, 64, cfg.d_model)
    td.inputs[0] = dataclasses.replace(td.inputs[0], lo=5, hi=3)
    with pytest.raises(ScheduleError, match="reversed"):
        tex.HANDLERS["GMM"](td, bad)


@pytest.mark.parametrize("entry", ["ExecutorState", "make_inputs",
                                   "make_inputs_plan"])
def test_executor_defaults_to_the_card(entry):
    """The executor's entry points put their tensors on the card unless the
    caller asks for the CPU: without a card the default raises, naming
    ``device='cpu'``; with ``device="cpu"`` they run. (On a machine with a
    card the default runs there; only the CPU half is checked.)"""
    plan_name = "skewed" if entry == "make_inputs_plan" else "balanced"
    cfg = _cfg("port", plan_name)
    fn = {"ExecutorState": lambda **kw: tex.ExecutorState(cfg, **kw),
          "make_inputs": lambda **kw: tex.make_inputs(cfg, 0, **kw),
          "make_inputs_plan":
              lambda **kw: tex.make_inputs_plan(cfg, 0, **kw)}[entry]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
    out = fn(device="cpu")
    if entry == "ExecutorState":
        assert out.device == torch.device("cpu")
        out.set_buffer("x", 0, np.zeros((2, 3), np.float32))
        tensors = [out.get("x", 0)]
    else:
        x_src, w1, w2 = out
        tensors = [*(x_src if isinstance(x_src, list) else [x_src]), w1, w2]
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for t in tensors)
    # A torch.device passed positionally, as the dropless layer passes one.
    if entry == "ExecutorState":
        assert tex.ExecutorState(cfg, torch.device("cpu")).device.type == \
            "cpu"
