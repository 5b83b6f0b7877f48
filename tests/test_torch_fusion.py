"""The port's fusion slice (``repro_torch.core.fusion``, the executor's
LayerBoundary/StageBoundary tiles, ``launch.dropless.FusedDroplessMoE``)
against the JAX package's, on the CPU.

Both packages build their plans and configs from their own classes and the
same numbers. Compiled fused and PP-fused schedules and their simulated
``SimResult``s must be equal, not close. Executed numbers are held within
1e-5 (the port's GMM tiles run ``torch.bmm``, the reference's numpy
matmul; behind the tests' standard normal boundary maps, 1e-5 of each
buffer's largest entry). Inside the port a fused taskflow equals its
fragments run one by one, and the fused dropless block its sequential
twin, bit for bit.
Every JAX dropless handle gets its own ``SSCCache``; the module fixture
of ``test_torch_dropless`` asserts that the JAX package's process-wide
cache ends the module as it began.
"""

import dataclasses
import importlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_dropless import process_caches_untouched  # noqa: E402,F401

MODULES = ("executor", "fusion", "hardware", "odg", "routing", "scheduler",
           "simulator", "ssc")
TOL = dict(rtol=1e-5, atol=1e-5)
EP, D = 3, 8


def _close_to_scale(got, want, err_msg=""):
    """|got - want| <= 1e-5 · max|want| over a buffer. The tests' standard
    normal boundary maps multiply magnitudes (dW entries reach ~300), and
    two summation orders of such sums differ by their rounding at that
    scale, not at each entry's own size."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=0,
        atol=1e-5 * max(1.0, float(np.abs(want).max(initial=0.0))),
        err_msg=err_msg)


def _pkg(root: str) -> types.SimpleNamespace:
    ns = types.SimpleNamespace(**{
        m: importlib.import_module(f"{root}.core.{m}") for m in MODULES})
    ns.dropless = importlib.import_module(f"{root}.launch.dropless")
    ns.moe = importlib.import_module(f"{root}.models.moe")
    ns.name = root
    return ns


J, T = _pkg("repro"), _pkg("repro_torch")


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _cpu(P):
    return {"device": "cpu"} if P is T else {}


def _plan_of(P, kind, seed):
    """``tests/test_fusion.py``'s plan kinds."""
    R = P.routing
    if kind == "skewed":
        return R.skewed_plan(EP, 2, 6, 1.0 + (seed % 3) * 0.5)
    if kind == "sparse":
        return R.random_plan(EP, 2, 7, np.random.default_rng(seed),
                             p_zero=0.5)
    return R.hotspot_plan(EP, 2, 4, background=seed % 3)


def _cfg(P, plan, topology=None):
    return P.odg.ScheduleConfig(ep=plan.ep, e_loc=plan.e_loc, rows=0,
                                d_model=D, d_ff=4, plan=plan,
                                topology=topology)


def _plain(s) -> dict:
    """A schedule as plain values, fragment table included."""
    return {"type": type(s).__name__, "direction": s.direction, "ep": s.ep,
            "tasks": [dataclasses.asdict(t) for t in s.tasks],
            "events": {k: dataclasses.asdict(e) for k, e in s.events.items()},
            "queues": list(s.queues.items()), "opts": s.opts,
            "fragments": [dataclasses.asdict(f)
                          for f in getattr(s, "fragments", ())]}


def _sims(P, s, pp=False) -> list:
    """Every simulation the fusion tests read, as plain values."""
    hw = P.hardware.AscendA3()
    runs = [P.simulator.simulate_unified(s, hw),
            P.simulator.simulate_baseline(s, hw)]
    runs.append(P.simulator.simulate_unified(
        s, hw, **({"stage_barrier": True} if pp
                  else {"fragment_barrier": True})))
    return [dataclasses.asdict(r) for r in runs]


PAIRS = [("skewed", "sparse", 1), ("sparse", "hotspot", 7),
         ("hotspot", "skewed", 12), ("hotspot", "hotspot", 5)]
PIPES = {"forward": ("ratr",), "backward": ("ratr", "gmm_interleave")}


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("kinds", PAIRS, ids=str)
def test_compile_fused_schedule_and_sim_equal(kinds, direction):
    """``compile_fused`` over the plan kinds and pipelines of
    ``tests/test_fusion.py``, K = 2 and 3: schedules and SimResults equal."""
    k0, k1, seed = kinds
    for K in (2, 3):
        out = {}
        for P in (J, T):
            cfgs = [_cfg(P, _plan_of(P, k, seed + i))
                    for i, k in enumerate((k0, k1, k0)[:K])]
            fs = P.fusion.compile_fused(cfgs, direction,
                                        pipeline=PIPES[direction])
            out[P.name] = (_plain(fs), _sims(P, fs))
        assert out["repro_torch"] == out["repro"]
    assert out["repro_torch"][0]["type"] == "FusedSchedule"


@pytest.mark.parametrize("M", [1, 2, 3])
@pytest.mark.parametrize("kinds", [("skewed", "hotspot"),
                                   ("sparse", "skewed", "hotspot")], ids=str)
def test_compile_pp_fused_schedule_and_sim_equal(kinds, M):
    """``compile_pp_fused`` over ``tests/test_pp_fusion.py``'s stage
    kinds and microbatch counts, both directions, with and without a
    topology: schedules and SimResults (``stage_barrier`` too) equal."""
    for direction in ("forward", "backward"):
        for topo in (None, 3):
            out = {}
            for P in (J, T):
                t = None if topo is None else P.hardware.Topology(
                    ranks_per_node=topo)
                cfgs = [_cfg(P, _plan_of(P, k, 9 + i), t)
                        for i, k in enumerate(kinds)]
                fs = P.fusion.compile_pp_fused(cfgs, M, direction=direction,
                                               pipeline=PIPES[direction])
                out[P.name] = (_plain(fs), _sims(P, fs, pp=True),
                               P.fusion.pp_cell_order(len(kinds), M,
                                                      direction))
            assert out["repro_torch"] == out["repro"]


def _matrices(plans_up, plans_dn, seed):
    """One rank-local map per rank (rows of the downstream send layout from
    rows of the upstream one), standard normals — the maps of
    ``tests/test_fusion.py`` and ``tests/test_pp_fusion.py``."""
    rng = np.random.default_rng(seed)
    return {r: rng.standard_normal(
                (plans_dn.send_rows(r), plans_up.send_rows(r))
            ).astype(np.float32) for r in range(EP)}


def _matrix_fn(P, A, transpose=False):
    A = A.T if transpose else A
    if P is T:
        A = torch.from_numpy(np.ascontiguousarray(A))

    def fn(data, lo, hi):
        if data is None:
            data = (A.new_zeros((A.shape[1], D)) if P is T
                    else np.zeros((A.shape[1], D), np.float32))
        return (A @ data)[lo:hi]
    return fn


def _fused_run(P, kinds, seed):
    """Forward and backward of a fused 2-layer taskflow with matrix
    boundaries, beside the layers run one by one through the package's
    own references; returns (fused buffers, sequential buffers)."""
    ex, fu = P.executor, P.fusion
    k0, k1 = kinds
    plans = [_plan_of(P, k0, seed), _plan_of(P, k1, seed + 1)]
    cfgs = [_cfg(P, p) for p in plans]
    M = _matrices(plans[0], plans[1], seed)
    x_src, w10, w20 = ex.make_inputs_plan(cfgs[0], seed % 97, **_cpu(P))
    _, w11, w21 = ex.make_inputs_plan(cfgs[1], (seed + 13) % 97, **_cpu(P))
    mul = (lambda A, b: torch.from_numpy(A) @ b) if P is T else \
        (lambda A, b: A @ b)
    ref0 = ex.reference_forward_plan(cfgs[0], x_src, w10, w20)
    ref1 = ex.reference_forward_plan(
        cfgs[1], [mul(M[r], ref0["y_ret"][r]) for r in range(EP)], w11, w21)
    fs = fu.compile_fused(cfgs, "forward", pipeline=PIPES["forward"])
    st = ex.ExecutorState(cfgs[0], fragment_cfgs=cfgs, **_cpu(P))
    fu.load_fused_forward_state(fs, cfgs, st, x_src, [w10, w11], [w20, w21])
    st.boundary_fns = {(0, r): _matrix_fn(P, M[r]) for r in range(EP)}
    ex.execute(fs, st, rng=np.random.default_rng(seed))

    rng = np.random.default_rng(seed + 5)
    dy1 = [rng.standard_normal(tuple(ref1["y_ret"][r].shape)).astype(
        np.float32) for r in range(EP)]
    if P is T:
        dy1 = [torch.from_numpy(a) for a in dy1]
    dx1, dw11, dw21 = ex.reference_backward_plan(cfgs[1], ref1, w11, w21,
                                                 dy1)
    dx0, dw10, dw20 = ex.reference_backward_plan(
        cfgs[0], ref0, w10, w20,
        [mul(M[r].T, dx1[r]) for r in range(EP)])
    fb = fu.compile_fused(cfgs, "backward", pipeline=PIPES["backward"])
    stb = ex.ExecutorState(cfgs[1], fragment_cfgs=cfgs[::-1], **_cpu(P))
    fu.load_fused_backward_state(fb, cfgs[::-1], stb, dy1, [ref1, ref0],
                                 [w11, w10], [w21, w20])
    stb.boundary_fns = {(0, r): _matrix_fn(P, M[r], transpose=True)
                        for r in range(EP)}
    ex.execute(fb, stb, rng=np.random.default_rng(seed + 1))

    fused, seq = {}, {}
    for r in range(EP):
        for i, (p, ref, dx, dw1, dw2) in enumerate(
                ((plans[0], ref0, dx0, dw10, dw20),
                 (plans[1], ref1, dx1, dw11, dw21))):
            if p.send_rows(r):
                fused[f"y_ret#L{i}", r] = st.get(f"y_ret#L{i}", r)
                seq[f"y_ret#L{i}", r] = ref["y_ret"][r]
                fused[f"dx_ret#L{i}", r] = stb.get(f"dx_ret#L{i}", r)
                seq[f"dx_ret#L{i}", r] = dx[r]
            if p.recv_rows(r):
                for n, w in (("dW1", dw1), ("dW2", dw2)):
                    fused[f"{n}#L{i}", r] = stb.get(f"{n}#L{i}", r)
                    seq[f"{n}#L{i}", r] = w[r]
    return fused, seq


@pytest.mark.parametrize("kinds", PAIRS, ids=str)
def test_fused_executor_matches_jax_and_its_layers(kinds):
    """The fused forward and backward walk with the tests' matrix
    boundaries: within 1e-5 of the JAX executor's buffers at each
    buffer's scale, and bit-equal to the port's own layers run one by
    one."""
    k0, k1, seed = kinds
    jf, _ = _fused_run(J, (k0, k1), seed)
    tf, ts = _fused_run(T, (k0, k1), seed)
    assert set(tf) == set(jf) and tf
    for key, want in jf.items():
        _close_to_scale(_np(tf[key]), want, err_msg=str(key))
        assert torch.equal(tf[key], ts[key]), key


@pytest.mark.parametrize("S,M", [(2, 2), (3, 1)])
def test_pp_fused_executor_matches_jax_and_its_cells(S, M):
    """The PP-fused walk (StageBoundary tiles, junction ``m*(S-1) + s``)
    forward: within 1e-5 of the JAX executor at each buffer's scale,
    bit-equal to the port's cells run one by one."""
    kinds = ("skewed", "hotspot", "sparse")[:S]
    got = {}
    for P in (J, T):
        ex, fu = P.executor, P.fusion
        plans = [_plan_of(P, k, 4 + i) for i, k in enumerate(kinds)]
        cfgs = [_cfg(P, p) for p in plans]
        mats = [_matrices(plans[s], plans[s + 1], 20 + s)
                for s in range(S - 1)]
        ws = [ex.make_inputs_plan(c, 13 * i, **_cpu(P))[1:]
              for i, c in enumerate(cfgs)]
        rng = np.random.default_rng(3)
        x_srcs = [[rng.standard_normal((plans[0].send_rows(r), D)).astype(
            np.float32) for r in range(EP)] for _ in range(M)]
        if P is T:
            x_srcs = [[torch.from_numpy(a) for a in x] for x in x_srcs]
        fs = fu.compile_pp_fused(cfgs, M, direction="forward",
                                 pipeline=("ratr",))
        st = ex.ExecutorState(cfgs[0],
                              fragment_cfgs=fu.pp_fragment_cfgs(fs, cfgs),
                              **_cpu(P))
        fu.load_pp_forward_state(fs, cfgs, st, x_srcs,
                                 [w[0] for w in ws], [w[1] for w in ws])
        st.boundary_fns = {(m * (S - 1) + s, r): _matrix_fn(P, mats[s][r])
                           for m in range(M) for s in range(S - 1)
                           for r in range(EP)}
        ex.execute(fs, st, rng=np.random.default_rng(1))
        out = {}
        for m in range(M):
            cur = x_srcs[m]
            for s in range(S):
                ref = ex.reference_forward_plan(cfgs[s], cur, *ws[s])
                for r in range(EP):
                    if plans[s].send_rows(r):
                        out[s, m, r] = (st.get(f"y_ret#S{s}M{m}", r),
                                        ref["y_ret"][r])
                if s < S - 1:
                    cur = [_matrix_fn(P, mats[s][r])(
                        ref["y_ret"][r], 0, plans[s + 1].send_rows(r))
                        for r in range(EP)]
        got[P.name] = out
    assert set(got["repro_torch"]) == set(got["repro"])
    for key, (fused, cells) in got["repro_torch"].items():
        assert torch.equal(fused, cells), key
        _close_to_scale(fused.numpy(), got["repro"][key][0],
                        err_msg=str(key))


def test_identity_boundary_fallback_and_its_errors():
    """Equal plans and no boundary fns: the identity fallback chains the
    layers (bit-equal in the port, within 1e-5 of JAX). Mismatched plans
    without a fn, and a fn returning the wrong rows, raise the reference's
    ``ScheduleError`` in both packages."""
    got = {}
    for P in (J, T):
        ex, fu = P.executor, P.fusion
        plan = P.routing.skewed_plan(EP, 2, 6, 1.5)
        cfg = _cfg(P, plan)
        fs = fu.compile_fused([cfg, cfg], "forward")
        x_src, w1, w2 = ex.make_inputs_plan(cfg, 3, **_cpu(P))
        ref0 = ex.reference_forward_plan(cfg, x_src, w1, w2)
        ref1 = ex.reference_forward_plan(cfg, ref0["y_ret"], w1, w2)
        st = ex.ExecutorState(cfg, fragment_cfgs=[cfg, cfg], **_cpu(P))
        fu.load_fused_forward_state(fs, [cfg, cfg], st, x_src, [w1, w1],
                                    [w2, w2])
        ex.execute(fs, st, rng=np.random.default_rng(0))
        got[P.name] = [(st.get("y_ret#L1", r), ref1["y_ret"][r])
                       for r in range(EP) if plan.send_rows(r)]

        other = _cfg(P, P.routing.hotspot_plan(EP, 2, 9))
        fs2 = fu.compile_fused([cfg, other], "forward")
        for fns, match in (({}, "identity boundary"),
                           ({(0, r): (lambda d, lo, hi: d[:1])
                             for r in range(EP)}, "boundary fn returned")):
            st2 = ex.ExecutorState(cfg, fragment_cfgs=[cfg, other],
                                   **_cpu(P))
            fu.load_fused_forward_state(fs2, [cfg, other], st2, x_src,
                                        [w1, w1], [w2, w2])
            st2.boundary_fns = fns
            with pytest.raises(P.scheduler.ScheduleError, match=match):
                ex.execute(fs2, st2, rng=np.random.default_rng(0))
    for (tf, tref), (jf, _) in zip(got["repro_torch"], got["repro"]):
        assert torch.equal(tf, tref)
        np.testing.assert_allclose(tf.numpy(), jf, **TOL)


def test_fusion_errors_equal_jax():
    """Each bad request raises the reference's exception type."""
    def bad_calls(P):
        fu = P.fusion
        a = _cfg(P, P.routing.skewed_plan(EP, 2, 6, 1.5))
        b = _cfg(P, P.routing.skewed_plan(2, 3, 6, 1.5))
        fwd = P.scheduler.compile_schedule(P.odg.build_moe_ffn_forward(a))
        bwd = P.scheduler.compile_schedule(P.odg.build_moe_ffn_backward(a))
        return [
            lambda: fu.compile_fused([], "forward"),
            lambda: fu.compile_fused([a, a], "sideways"),
            lambda: fu.compile_fused([a, b], "forward"),
            lambda: fu.compile_fused([a, a], "forward", pipelines=[None]),
            lambda: fu.fuse_schedules([], []),
            lambda: fu.fuse_schedules([fwd], [a, a]),
            lambda: fu.fuse_schedules([fwd, bwd], [a, a]),
            lambda: fu.fuse_schedules([fwd, fwd], [a, a],
                                      labels=["L0", "L0"]),
            lambda: fu.compile_pp_fused([], 2),
            lambda: fu.compile_pp_fused([a], 0, n_stages=2),
            lambda: fu.compile_pp_fused([a, a], 1, n_stages=3),
            lambda: fu.compile_pp_fused([a, a], 1, direction="up"),
            lambda: fu.compile_pp_fused([a], 1, n_stages=2,
                                        pipelines=[None]),
            lambda: fu.fuse_pp_schedules([fwd, bwd], [a, a], 1)]
    for tcall, jcall in zip(bad_calls(T), bad_calls(J)):
        with pytest.raises(Exception) as je:
            jcall()
        with pytest.raises(Exception) as te:
            tcall()
        assert type(te.value).__name__ == type(je.value).__name__
        assert str(te.value) == str(je.value)


def test_loaders_put_tensors_on_the_state_device():
    """The fused loaders take numpy arrays or tensors and hold fp32
    tensors on the ``ExecutorState``'s device."""
    plan = T.routing.skewed_plan(EP, 2, 6, 1.5)
    cfg = _cfg(T, plan)
    fs = T.fusion.compile_fused([cfg, cfg], "forward")
    x_src, w1, w2 = J.executor.make_inputs_plan(_cfg(J, J.routing.skewed_plan(
        EP, 2, 6, 1.5)), 3)
    st = T.executor.ExecutorState(cfg, device="cpu",
                                  fragment_cfgs=[cfg, cfg])
    T.fusion.load_fused_forward_state(fs, [cfg, cfg], st, x_src, [w1, w1],
                                      [w2, w2.astype(np.float64)])
    for t in list(st.buffers.values()) + list(st.weights.values()):
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
        assert t.device == st.device
    assert torch.equal(st.get("W2#L1", 0), torch.from_numpy(w2[0]))


# ---------------------------------------------------------------------------
# FusedDroplessMoE against JAX's.
# ---------------------------------------------------------------------------


def _moe_params(K, seed=0, d=16, E=6, f=8):
    rng = np.random.default_rng(seed)
    ps = [{"router": (rng.standard_normal((d, E)) / 4).astype(np.float32),
           "w_in": (rng.standard_normal((E, d, 2 * f)) / 4).astype(
               np.float32),
           "w_down": (rng.standard_normal((E, f, d)) / 3).astype(np.float32)}
          for _ in range(K)]
    x = rng.standard_normal((2, 12, d)).astype(np.float32)
    gy = rng.standard_normal((2, 12, d)).astype(np.float32)
    return ps, x, gy


def _mc(P):
    return P.moe.MoEConfig(n_experts=6, top_k=2, d_expert=8,
                           capacity_factor=8.0)


def _port_block(h, ps, x, gy):
    tp = [{k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
          for p in ps]
    tx = torch.tensor(x, requires_grad=True)
    y = h.impl(tp, tx, _mc(T))
    y.backward(torch.from_numpy(gy))
    return [y.detach(), tx.grad] + [p[k].grad for p in tp for k in sorted(p)]


@pytest.mark.parametrize("K", [2, 3])
@pytest.mark.parametrize("fuse", [True, False, "auto"])
def test_fused_dropless_block_matches_jax(K, fuse):
    """Output and grads (x, each router, w_in, w_down) within 1e-5 of JAX's
    ``FusedDroplessMoE`` under ``jax.vjp``; inside the port the block
    equals its sequential twin bit for bit; the caches see the same
    entries, fragments and hit/miss counts."""
    import jax
    import jax.numpy as jnp
    ps, x, gy = _moe_params(K, seed=K)
    jh = J.dropless.FusedDroplessMoE(
        J.dropless.DroplessConfig(ep=3, bucket=4),
        cache=J.ssc.SSCCache(max_entries=8), fuse=fuse)
    th = T.dropless.FusedDroplessMoE(
        T.dropless.DroplessConfig(ep=3, bucket=4),
        cache=T.ssc.SSCCache(max_entries=8), fuse=fuse, device="cpu")
    twin = T.dropless.FusedDroplessMoE(
        T.dropless.DroplessConfig(ep=3, bucket=4),
        cache=T.ssc.SSCCache(max_entries=8), fuse=fuse is not True,
        device="cpu")
    y, vjp = jax.vjp(lambda pp, xx: jh.impl(pp, xx, _mc(J)),
                     [{k: jnp.asarray(v) for k, v in p.items()} for p in ps],
                     jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(gy))
    want = [np.asarray(y), np.asarray(gx)] + [
        np.asarray(p[k]) for p in gp for k in sorted(p)]
    got = _port_block(th, ps, x, gy)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), b, **TOL, err_msg=str(i))
    for a, b in zip(got, _port_block(twin, ps, x, gy)):
        assert torch.equal(a, b)
    ji, ti = jh.cache.info(), th.cache.info()
    for k in ("hits", "misses", "entries", "exact_rows", "padded_rows"):
        assert ti[k] == ji[k], k
    assert [e["fragments"] for e in ti["per_entry"]] == \
        [e["fragments"] for e in ji["per_entry"]]
    assert list(th.cache._cache) == list(jh.cache._cache)


def test_fused_dropless_validation_matches_jax():
    dc = {P.name: P.dropless.DroplessConfig(ep=3) for P in (J, T)}
    for P in (J, T):
        kw = _cpu(P)
        with pytest.raises(ValueError, match="auto"):
            P.dropless.FusedDroplessMoE(dc[P.name], fuse="sometimes",
                                        cache=P.ssc.SSCCache(), **kw)
        with pytest.raises(ValueError, match="SwiGLU"):
            P.dropless.FusedDroplessMoE(dc[P.name], act="gelu",
                                        cache=P.ssc.SSCCache(), **kw)
    ps, x, _ = _moe_params(1)
    h = T.dropless.FusedDroplessMoE(dc["repro_torch"],
                                    cache=T.ssc.SSCCache(), device="cpu")
    tp = [{k: torch.from_numpy(v) for k, v in p.items()} for p in ps]
    with pytest.raises(ValueError, match=">= 2 layers"):
        h.impl(tp, torch.from_numpy(x), _mc(T))
    with pytest.raises(ValueError, match="not divisible"):
        h.impl(tp * 2, torch.from_numpy(x[:, :11]), _mc(T))


@pytest.mark.parametrize("capacity", [None, 3])
@pytest.mark.parametrize("ep", [1, 2, 4])
def test_boundary_remaps_equal_jax(ep, capacity):
    """``fused_boundary_forward`` / ``_backward`` per rank, on bridges with
    and without capacity drops: bit-equal to the reference's numpy remaps
    (elementwise fp32 products and sums in the same order), every tile
    slice of the memoized buffer included."""
    rng = np.random.default_rng(ep)
    d = 16
    tis = [rng.integers(0, 8, (32, 2)) for _ in range(2)]
    tp = rng.random((32, 2)).astype(np.float32)
    mcs = {P.name: P.moe.MoEConfig(n_experts=8, top_k=2, d_expert=8)
           for P in (J, T)}
    br = {P.name: [P.moe.plan_from_routing(ti, mcs[P.name], ep,
                                           capacity=capacity, bucket=4)
                   for ti in tis] for P in (J, T)}
    up, dn = br["repro"]
    ret = [rng.standard_normal((up.plan.send_rows(r), d)).astype(np.float32)
           for r in range(ep)]
    dxr = [rng.standard_normal((dn.plan.send_rows(r), d)).astype(np.float32)
           for r in range(ep)]
    for name, data, rows_of in (
            ("fused_boundary_forward", ret, dn.plan.send_rows),
            ("fused_boundary_backward", dxr, up.plan.send_rows)):
        jf = getattr(J.moe, name)(*br["repro"], tp, d)
        tf = getattr(T.moe, name)(*br["repro_torch"], torch.from_numpy(tp),
                                  d)
        for r in range(ep):
            n = rows_of(r)
            arg = data[r] if data[r].shape[0] else None
            want = jf[r](arg, 0, n)
            got = tf[r](None if arg is None else torch.from_numpy(arg), 0, n)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
            for lo, hi in ((0, n // 2), (n // 2, n)):
                np.testing.assert_array_equal(
                    tf[r](None, lo, hi).numpy(), want[lo:hi])
