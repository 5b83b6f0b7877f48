"""The port's elastic remapping (``repro_torch.core.elastic``) and
``DroplessMoE.rescale(dead_ranks=)`` against the JAX package's, on the CPU.

Remapped plans, invariant reports, rank biases and errors must equal the
reference's exactly; executed numbers are held within 1e-5 (``torch.bmm``
against numpy matmul). Inside the port a remapped plan's backward equals
the small mesh's references bit for bit; its survivors' forward equals the
old mesh's run within 1e-5 here, where ``torch.bmm`` blocks its sums by the
call's rows, and bit for bit on the card (``chip_smoke.py`` phase 12). The
property twin of the reference's ``test_remap_invariants_property`` draws
only legal ``hotspot_plan`` arguments; the reference's draws include one
that ``hotspot_plan`` refuses, and both packages refuse it alike.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _proptest import given, settings, st  # noqa: E402
from test_torch_dropless import process_caches_untouched  # noqa: E402,F401

import repro.launch.dropless as jdl  # noqa: E402
import repro_torch.launch.dropless as tdl  # noqa: E402
from repro.core import elastic as jel  # noqa: E402
from repro.core import executor as jex  # noqa: E402
from repro.core import odg as jodg  # noqa: E402
from repro.core import routing as jrouting  # noqa: E402
from repro.core.scheduler import compile_schedule as jcompile  # noqa: E402
from repro.core.ssc import SSCCache as JCache  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.core import costmodel as tcost  # noqa: E402
from repro_torch.core import elastic as tel  # noqa: E402
from repro_torch.core import executor as tex  # noqa: E402
from repro_torch.core import odg as todg  # noqa: E402
from repro_torch.core import routing as trouting  # noqa: E402
from repro_torch.core.scheduler import (  # noqa: E402
    compile_schedule as tcompile)
from repro_torch.core.ssc import SSCCache as TCache  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
PKG = {"jax": (jrouting, jel, jodg, jex, jcompile),
       "port": (trouting, tel, todg, tex, tcompile)}


def _plan(R, kind):
    """ep = 4, e_loc = 3: 12 experts divide every survivor count."""
    if kind == "skewed":
        return R.skewed_plan(4, 3, 9, alpha=1.5)
    if kind == "hotspot":
        return R.hotspot_plan(4, 3, 6, background=1)
    if kind == "node_limited":
        return R.node_limited_plan(4, 3, 5, node_size=2, m_nodes=1)
    if kind == "random":
        return R.random_plan(4, 3, 12, np.random.default_rng(7), p_zero=0.3)
    if kind == "empty_src":
        c = np.random.default_rng(3).integers(0, 5, (4, 4, 3))
        c[2] = 0
        return R.RoutingPlan.from_counts(c)
    raise KeyError(kind)


KINDS = ("skewed", "hotspot", "node_limited", "random", "empty_src")
DEAD = ([0], [1], [3], [1, 3], [0, 2], [0, 1, 2], [])


def _plain(plan) -> dict:
    return {"counts": plan.counts, "ep": plan.ep, "e_loc": plan.e_loc,
            "send": [plan.send_rows(r) for r in range(plan.ep)],
            "recv": [plan.recv_rows(r) for r in range(plan.ep)],
            "send_offsets": np.asarray(plan.send_offsets).tolist(),
            "expert_offsets": [[plan.expert_offset(r, e)
                                for e in range(plan.e_loc)]
                               for r in range(plan.ep)]}


@pytest.mark.parametrize("kind", KINDS)
def test_remap_plan_and_report_equal_jax(kind):
    """Every dead set and every new mesh size: counts, offsets and
    ``check_remap``'s report equal the reference's."""
    for dead in DEAD:
        out = {}
        for name, (R, E, *_) in PKG.items():
            plan = _plan(R, kind)
            new = E.remap_plan(plan, dead_ranks=dead)
            surv = E.surviving_ranks(4, dead)
            out[name] = (_plain(new), surv, E.check_remap(plan, new, surv),
                         E._offsets_valid(new))
        assert out["port"] == out["jax"], dead
        assert out["port"][2]["ok"]
    for new_ep in (1, 2, 3, 4, 6, 12):
        got = [_plain(E.remap_plan(_plan(R, kind), new_ep=new_ep))
               for (R, E, *_) in PKG.values()]
        assert got[0] == got[1], new_ep


def _errors(R, E):
    plan = R.balanced_plan(4, 3, 2)
    w = np.zeros((12, 2, 2), np.float32)
    return [lambda: E.remap_plan(plan),
            lambda: E.remap_plan(plan, dead_ranks=[0], new_ep=2),
            lambda: E.remap_plan(plan, dead_ranks=[4]),
            lambda: E.remap_plan(plan, dead_ranks=[-1]),
            lambda: E.remap_plan(plan, dead_ranks=[0, 1, 2, 3]),
            lambda: E.remap_plan(plan, new_ep=5),
            lambda: E.remap_plan(plan, new_ep=0),
            lambda: E.rechunk_expert_array(w, 7),
            lambda: E.rank_bias_from_times([]),
            lambda: E.rank_bias_from_times([1.0, -1.0]),
            lambda: R.hotspot_plan(4, 3, 4, background=2)]


def test_errors_equal_jax():
    """Each bad input raises the reference's exception, message and all
    (``hotspot_plan``'s refusal of the draw the reference's property test
    trips on included)."""
    for tcall, jcall in zip(_errors(trouting, tel), _errors(jrouting, jel)):
        with pytest.raises(Exception) as je:
            jcall()
        with pytest.raises(Exception) as te:
            tcall()
        assert type(te.value).__name__ == type(je.value).__name__
        assert str(te.value) == str(je.value)


def test_hotspot_refusal_equals_jax():
    """The draw that the reference's ``test_remap_invariants_property``
    makes for seeds = 8 (mod 12), ``hotspot_plan(4, 3, 4, background=2)``,
    needs (2 + 3) x 11 = 55 background rows of a source's 48: both packages
    refuse it with the same ValueError."""
    msgs = []
    for R in (jrouting, trouting):
        with pytest.raises(ValueError) as e:
            R.hotspot_plan(4, 3, 4, background=2)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == \
        "background traffic exceeds per-source token count"


def _drawn_plan(R, kind, seed):
    """The reference property test's plan zoo (``tests/test_elastic.py``),
    with hotspot rows raised to 5 where background 2 needs them: every
    draw is a legal ``hotspot_plan`` call."""
    if kind == "skewed":
        return R.skewed_plan(4, 3, 8 + seed % 5, alpha=0.5 + (seed % 4) * 0.5)
    if kind == "hotspot":
        bg = seed % 3
        return R.hotspot_plan(4, 3, max(4 + seed % 4, 5 if bg == 2 else 4),
                              background=bg)
    if kind == "node_limited":
        return R.node_limited_plan(4, 3, 4 + seed % 4, node_size=2,
                                   m_nodes=1 + seed % 2)
    return R.random_plan(4, 3, 12, np.random.default_rng(seed), p_zero=0.3)


@settings(max_examples=25, deadline=None)
@given(st.sampled_from(["skewed", "hotspot", "node_limited", "random"]),
       st.integers(0, 10 ** 6),
       st.lists(st.integers(0, 3), min_size=1, max_size=3, unique=True))
def test_remap_invariants_property_equals_jax(kind, seed, dead):
    """The reference's remap invariants over random plans and dead sets,
    with the port's remapped plan and report equal to the reference's."""
    out = {}
    for name, (R, E, *_) in PKG.items():
        plan = _drawn_plan(R, kind, seed)
        survivors = E.surviving_ranks(4, dead)
        new = E.remap_plan(plan, dead_ranks=dead)
        assert new.ep == len(survivors) and new.ep * new.e_loc == 12
        report = E.check_remap(plan, new, survivors)
        assert report["ok"], report
        assert E.remap_plan(new, dead_ranks=[]).counts == new.counts
        assert E.remap_plan(new, new_ep=new.ep).counts == new.counts
        assert new.total_rows == sum(plan.send_rows(r) for r in survivors)
        out[name] = (_plain(new), report)
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("new_ep,e_total", [(2, 12), (3, None), (6, 12)])
def test_rechunk_expert_array_numpy_and_torch(new_ep, e_total):
    """Logical [e_total, ...] and per-rank [ep, e_loc, ...] forms re-chunk
    as the reference's; a tensor comes back a tensor view of the same
    values."""
    w = np.arange(12 * 5 * 7, dtype=np.float32).reshape(12, 5, 7)
    per_rank = w.reshape(4, 3, 5, 7)
    for arr in (w, per_rank):
        want = jel.rechunk_expert_array(arr, new_ep, e_total=e_total)
        got = tel.rechunk_expert_array(arr, new_ep, e_total=e_total)
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want)
        t = torch.from_numpy(arr)
        gt = tel.rechunk_expert_array(t, new_ep, e_total=e_total)
        assert isinstance(gt, torch.Tensor) and gt.data_ptr() == t.data_ptr()
        np.testing.assert_array_equal(gt.numpy(), want)
    with pytest.raises(ValueError, match="re-chunk"):
        tel.rechunk_expert_array(torch.from_numpy(w), 7)


@pytest.mark.parametrize("times", [[100.0, 100.0, 100.0],
                                   [100.0, 100.0, 400.0],
                                   [1.0] * 9 + [1e9], [0.0, 0.0],
                                   [300.0, 100.0, 100.0, 100.0]])
def test_rank_bias_and_observed_cost_model_equal_jax(times):
    assert tel.rank_bias_from_times(times) == jel.rank_bias_from_times(times)
    assert tel.BIAS_FLOOR == jel.BIAS_FLOOR and \
        tel.BIAS_CEIL == jel.BIAS_CEIL
    tcm, jcm = tel.observed_cost_model(times), jel.observed_cost_model(times)
    assert tcm.rank_bias == jcm.rank_bias
    assert dataclasses.asdict(tcm) == dataclasses.asdict(jcm)
    hash(tcm)
    base = tcost.CostModel(l2=False)
    assert tel.observed_cost_model(None, base) is base


def _small_cfg(odg, plan):
    return odg.ScheduleConfig(ep=plan.ep, e_loc=plan.e_loc, rows=0,
                              d_model=8, d_ff=4, plan=plan)


@pytest.mark.parametrize("kind,dead", [
    ("skewed", [1]), ("hotspot", [0]), ("random", [0, 2]),
    ("node_limited", [3]), ("empty_src", [1, 3])])
def test_remap_executor_parity(kind, dead):
    """``tests/test_elastic.py``'s remapped-plan executor parity in the
    port: the remapped plan's forward equals the old mesh's survivors
    within 1e-5 (bit for bit on the card), its backward equals the small
    mesh's references bit for bit, and both are within 1e-5 of the JAX
    executor's."""
    got = {}
    for name, (R, E, odg, ex, compile_schedule) in PKG.items():
        cpu = {"device": "cpu"} if name == "port" else {}
        plan = _plan(R, kind)
        surv = E.surviving_ranks(4, dead)
        new = E.remap_plan(plan, dead_ranks=dead)
        old_cfg, new_cfg = _small_cfg(odg, plan), _small_cfg(odg, new)
        x_src, w1, w2 = ex.make_inputs_plan(old_cfg, 3, **cpu)
        x_small = [x_src[r] for r in surv]
        w1s = E.rechunk_expert_array(w1, new.ep, e_total=12)
        w2s = E.rechunk_expert_array(w2, new.ep, e_total=12)
        fwd_old = ex.reference_forward_plan(old_cfg, x_src, w1, w2)
        st = ex.ExecutorState(new_cfg, **cpu)
        ex.load_forward_state_plan(new_cfg, st, x_small, w1s, w2s)
        ex.execute(compile_schedule(odg.build_moe_ffn_forward(new_cfg),
                                    ratr=True),
                   st, rng=np.random.default_rng(0))
        fwd_small = ex.reference_forward_plan(new_cfg, x_small, w1s, w2s)
        rng = np.random.default_rng(11)
        dy = [rng.standard_normal(tuple(fwd_small["y_ret"][i].shape))
              .astype(np.float32) for i in range(new.ep)]
        if name == "port":
            dy = [torch.from_numpy(a) for a in dy]
        stb = ex.ExecutorState(new_cfg, **cpu)
        ex.load_backward_state_plan(new_cfg, stb, fwd_small, w1s, w2s, dy)
        ex.execute(compile_schedule(odg.build_moe_ffn_backward(new_cfg),
                                    ratr=True, gmm_interleave=True),
                   stb, rng=np.random.default_rng(1))
        dx, dw1, dw2 = ex.reference_backward_plan(new_cfg, fwd_small, w1s,
                                                  w2s, dy)
        out = {}
        for i, r in enumerate(surv):
            if new.send_rows(i):
                out["y_ret", i] = (st.get("y_ret", i), fwd_old["y_ret"][r])
                out["dx_ret", i] = (stb.get("dx_ret", i), dx[i])
            if new.recv_rows(i):
                out["dW1", i] = (stb.get("dW1", i), dw1[i])
                out["dW2", i] = (stb.get("dW2", i), dw2[i])
        got[name] = out
    assert set(got["port"]) == set(got["jax"]) and got["port"]
    for key, (a, want) in got["port"].items():
        if key[0] == "y_ret":
            # Other row counts per GMM call: torch.bmm on the CPU blocks
            # its sums by the rows, the card's fp32 body does not (there
            # chip_smoke.py's phase 12 holds this bit for bit).
            np.testing.assert_allclose(a.numpy(), want.numpy(), **TOL)
        else:
            assert torch.equal(a, want), key
        np.testing.assert_allclose(a.numpy(), got["jax"][key][0], **TOL,
                                   err_msg=str(key))


def _moe_case(seed=0, d=16, E=12, f=8, T=24):
    rng = np.random.default_rng(seed)
    params = {"router": (rng.standard_normal((d, E)) / 4).astype(np.float32),
              "w_in": (rng.standard_normal((E, d, 2 * f)) / 4).astype(
                  np.float32),
              "w_down": (rng.standard_normal((E, f, d)) / 3).astype(
                  np.float32)}
    x = rng.standard_normal((1, T, d)).astype(np.float32)
    gy = rng.standard_normal((1, T, d)).astype(np.float32)
    return params, x, gy


@pytest.mark.parametrize("dead", [[1, 3], [0]])
def test_rescale_dead_ranks_matches_jax_and_native(dead):
    """``DroplessMoE(ep=4).rescale(dead_ranks=...)``: the survivor mesh,
    the shared and re-keyed cache, and an output and grads equal to a
    natively built handle's (bit for bit) and JAX's rescaled handle's
    (within 1e-5)."""
    import jax
    import jax.numpy as jnp
    params, x, gy = _moe_case()
    mcs = {"port": tmoe.MoEConfig(n_experts=12, top_k=2, d_expert=8),
           "jax": jmoe.MoEConfig(n_experts=12, top_k=2, d_expert=8)}
    big = {"port": tdl.DroplessMoE(tdl.DroplessConfig(ep=4),
                                   cache=TCache(max_entries=8)),
           "jax": jdl.DroplessMoE(jdl.DroplessConfig(ep=4, bucket=16),
                                  cache=JCache(max_entries=8))}
    small = {n: h.rescale(dead_ranks=dead) for n, h in big.items()}
    n_surv = 4 - len(dead)
    assert small["port"].dc == tdl.DroplessConfig(ep=n_surv)
    assert small["jax"].dc.ep == n_surv
    for n in big:
        assert small[n].cache is big[n].cache
        assert big[n].cache.info()["active_ep"] == n_surv
    native = tdl.DroplessMoE(tdl.DroplessConfig(ep=n_surv),
                             cache=TCache(max_entries=8))
    got = {}
    for name, h in (("rescaled", small["port"]), ("native", native)):
        p = {k: torch.tensor(v, requires_grad=True)
             for k, v in params.items()}
        xx = torch.tensor(x, requires_grad=True)
        y = h.impl(p, xx, mcs["port"])
        y.backward(torch.from_numpy(gy))
        got[name] = [y.detach(), xx.grad] + [p[k].grad for k in sorted(p)]
    for a, b in zip(got["rescaled"], got["native"]):
        assert torch.equal(a, b)
    y, vjp = jax.vjp(lambda p, xx: small["jax"].impl(p, xx, mcs["jax"]),
                     {k: jnp.asarray(v) for k, v in params.items()},
                     jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(gy))
    want = [np.asarray(y), np.asarray(gx)] + [np.asarray(gp[k])
                                              for k in sorted(gp)]
    for a, b in zip(got["rescaled"], want):
        np.testing.assert_allclose(a.numpy(), b, **TOL)
