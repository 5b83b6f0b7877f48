"""The port's dropless path (``repro_torch.launch.dropless``, the routing
bridge in ``repro_torch.models.moe``, dropless training steps and
``train --dropless``) against the JAX package's, on the CPU.

Inputs are made once in numpy from a seed and fed to both packages; fp32
results are held within 1e-5, the bridge's rows and buffers bit for bit.

The JAX package keeps one process-wide SSC cache
(``repro.launch.dropless._PROCESS_CACHE``) for every ``DroplessMoE`` built
without ``cache=`` and every ``make_steps(dropless=...)``, and its own
tests count that cache's entries. Tests here share a worker process with
those, so they must leave it as they found it: every JAX ``DroplessMoE``
gets its own ``SSCCache``, JAX's ``make_steps(dropless=...)`` runs with the
process cache swapped out and put back, and a module fixture asserts at the
end that the process cache is the same object with the same counters.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.launch.dropless as jdl  # noqa: E402
import repro_torch.launch.dropless as tdl  # noqa: E402
from repro.core.ssc import SSCCache as JCache  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.core.ssc import SSCCache as TCache  # noqa: E402
from repro_torch.launch import steps as TSt  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
ARCH = "granite-moe-3b-a800m"
TOL = dict(rtol=1e-5, atol=1e-5)


def _cache_state(mod):
    c = mod._PROCESS_CACHE
    return c, (None if c is None else c.info())


@pytest.fixture(scope="module", autouse=True)
def process_caches_untouched():
    """Both packages' process-wide caches end the module as they began."""
    before = {m: _cache_state(m) for m in (jdl, tdl)}
    yield
    for m, (cache, info) in before.items():
        now, now_info = _cache_state(m)
        assert now is cache, f"{m.__name__}._PROCESS_CACHE was replaced"
        assert now_info == info, f"{m.__name__}._PROCESS_CACHE was used"


@pytest.fixture
def fresh_process_caches(monkeypatch):
    """Code under test that reaches ``get_process_cache`` gets a new cache;
    monkeypatch puts the old one back at teardown."""
    monkeypatch.setattr(jdl, "_PROCESS_CACHE", None)
    monkeypatch.setattr(tdl, "_PROCESS_CACHE", None)


def _moe_case(seed=0, d=16, E=8, f=8, B=2, S=16):
    rng = np.random.default_rng(seed)
    params = {"router": (rng.standard_normal((d, E)) / 4).astype(np.float32),
              "w_in": (rng.standard_normal((E, d, 2 * f)) / 4).astype(
                  np.float32),
              "w_down": (rng.standard_normal((E, f, d)) / 3).astype(
                  np.float32)}
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    gy = rng.standard_normal((B, S, d)).astype(np.float32)
    return params, x, gy


def _mcs(E=8, k=2, f=8, **kw):
    return (jmoe.MoEConfig(n_experts=E, top_k=k, d_expert=f, **kw),
            tmoe.MoEConfig(n_experts=E, top_k=k, d_expert=f, **kw))


# ---------------------------------------------------------------------------
# The routing bridge.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bucket", [1, 8, "geometric:8"])
@pytest.mark.parametrize("capacity", [None, 3])
@pytest.mark.parametrize("ep", [1, 2, 4])
def test_bridge_matches_jax(ep, capacity, bucket):
    """Plan counts, send rows, dispatched buffers and the combine equal the
    reference's bit for bit, with and without capacity drops."""
    jmc, tmc = _mcs()
    rng = np.random.default_rng(ep)
    ti = rng.integers(0, 8, (32, 2))
    x = rng.standard_normal((ep, 32 // ep, 16)).astype(np.float32)
    tp = rng.random((32, 2)).astype(np.float32)
    jb = jmoe.plan_from_routing(ti, jmc, ep, capacity=capacity,
                                bucket=bucket)
    tb = tmoe.plan_from_routing(ti, tmc, ep, capacity=capacity,
                                bucket=bucket)
    assert tb.plan.counts == jb.plan.counts
    np.testing.assert_array_equal(tb.send_row, jb.send_row)
    assert tb.dropped == bool((jb.send_row < 0).any()) == \
        (capacity is not None)
    for a, b in zip(tmoe.bridge_dispatch(tb, torch.from_numpy(x)),
                    jmoe.bridge_dispatch(jb, x)):
        np.testing.assert_array_equal(a.numpy(), b)
    y_ret = [rng.standard_normal((jb.plan.send_rows(s), 16)).astype(
        np.float32) for s in range(ep)]
    got = tmoe.bridge_combine(tb, [torch.from_numpy(a) for a in y_ret],
                              torch.from_numpy(tp))
    np.testing.assert_array_equal(got.numpy(),
                                  jmoe.bridge_combine(jb, y_ret, tp))


@pytest.mark.parametrize("bucket", [1, 4, "geometric:4"])
def test_routed_and_bucket_counts_match_jax(bucket):
    jmc, tmc = _mcs()
    ti = np.random.default_rng(5).integers(0, 8, (64, 2))
    for ep in (1, 2, 4):
        c = tmoe.routed_counts(ti, tmc, ep)
        np.testing.assert_array_equal(c, jmoe.routed_counts(ti, jmc, ep))
        np.testing.assert_array_equal(tmoe.bucket_counts(c, bucket),
                                      jmoe.bucket_counts(c, bucket))
    for bad in (dict(ep=3), dict(ep=16)):
        with pytest.raises(ValueError):
            tmoe.plan_from_routing(ti, tmc, **bad)


# ---------------------------------------------------------------------------
# DroplessMoE.impl: forward and grads against JAX's custom-vjp fragment.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bucket", [1, "geometric:8"])
@pytest.mark.parametrize("ep", [1, 2, 4])
def test_impl_matches_jax(ep, bucket):
    """``DroplessMoE.impl``'s output and its grads (x, router, w_in, w_down)
    against JAX's ``DroplessMoE.impl`` under ``jax.vjp``; the two caches
    see the same hit/miss sequence."""
    params, x, gy = _moe_case(ep)
    jmc, tmc = _mcs()
    jm = jdl.DroplessMoE(jdl.DroplessConfig(ep=ep, bucket=bucket),
                         cache=JCache(max_entries=8))
    tm = tdl.DroplessMoE(tdl.DroplessConfig(ep=ep, bucket=bucket),
                         cache=TCache(max_entries=8))
    y, vjp = jax.vjp(lambda p, xx: jm.impl(p, xx, jmc),
                     {k: jnp.asarray(v) for k, v in params.items()},
                     jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(gy))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    ty = tm.impl(tp, tx, tmc)
    ty.backward(torch.from_numpy(gy))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **TOL)
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(gp[k]),
                                   **TOL, err_msg=k)
    ji, ti_ = jm.cache.info(), tm.cache.info()
    for k in ("hits", "misses", "entries", "exact_rows", "padded_rows"):
        assert ti_[k] == ji[k], k
    assert tm.step_stats() == jm.step_stats()


def test_impl_matches_fixed_capacity_moe_grouped():
    """With a capacity that drops nothing, the dropless fragment equals the
    fixed-capacity ``moe_grouped`` (the einsum FFN), forward and grads."""
    params, x, gy = _moe_case(3, B=1, S=32)
    _, tmc = _mcs(capacity_factor=8.0)
    tm = tdl.DroplessMoE(tdl.DroplessConfig(ep=2, bucket=8),
                         cache=TCache(max_entries=8))
    out = {}
    for name, fn in (("dropless", tm.impl),
                     ("grouped", lambda p, xx, mc: tmoe.moe_grouped(
                         p, xx, mc, cap=10_000))):
        p = {k: torch.tensor(v, requires_grad=True)
             for k, v in params.items()}
        xx = torch.tensor(x, requires_grad=True)
        y = fn(p, xx, tmc)
        y.backward(torch.from_numpy(gy))
        out[name] = [y.detach(), xx.grad] + [p[k].grad for k in params]
    for a, b in zip(out["dropless"], out["grouped"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_bucketed_key_collision_reuses_the_schedule():
    """Two routings whose counts land in one bucket share one compiled
    schedule, and both still compute their own result."""
    d = 16
    params, _, _ = _moe_case(0, d=d, E=4)
    _, tmc = _mcs(E=4, capacity_factor=8.0)
    rng = np.random.default_rng(11)
    xs = [rng.standard_normal((1, 32, d)).astype(np.float32)
          for _ in range(2)]
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tis = [tmoe.router_topk(tp["router"], torch.from_numpy(x[0]), tmc)[1]
           .numpy() for x in xs]
    plans = [tmoe.plan_from_routing(ti, tmc, 2, capacity=None,
                                    bucket=64).plan for ti in tis]
    assert plans[0].counts == plans[1].counts
    assert not np.array_equal(*[tmoe.plan_from_routing(
        ti, tmc, 2, capacity=None).plan.counts for ti in tis])
    cache = TCache(max_entries=8)
    tm = tdl.DroplessMoE(tdl.DroplessConfig(ep=2, bucket=64),
                         cache=cache)
    for i, x in enumerate(xs):
        with torch.no_grad():
            y = tm.impl(tp, torch.from_numpy(x), tmc)
        assert (cache.misses, cache.hits) == (1, i)
        want = tmoe.moe_grouped(tp, torch.from_numpy(x), tmc, cap=10_000)
        np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_live_seam_sees_host_routing_both_directions():
    params, x, gy = _moe_case(1)
    _, tmc = _mcs()
    dc = tdl.DroplessConfig(ep=2, bucket=4)
    seen = []

    def live(top_i, mc, direction):
        assert isinstance(top_i, np.ndarray) and top_i.shape == (32, 2)
        seen.append(direction)
        return dc

    impl = tdl._make_impl(dc, TCache(), live=live)
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    impl(p, torch.from_numpy(x), tmc).backward(torch.from_numpy(gy))
    assert seen == ["forward", "backward"]


# ---------------------------------------------------------------------------
# Config, handle and process cache.
# ---------------------------------------------------------------------------


def test_config_validation_matches_jax():
    for mod in (jdl, tdl):
        with pytest.raises(ValueError, match="auto"):
            mod.DroplessConfig(pipeline="ratr")
        with pytest.raises(KeyError):
            mod.DroplessConfig(pipeline=("no_such_pass",))
        with pytest.raises(ValueError):
            mod.DroplessConfig(bucket="nonsense:3")
        assert mod.DroplessConfig(pipeline="auto").pipeline_spec() == "auto"
    for kw in (dict(), dict(bucket=8), dict(bucket="geometric:8"),
               dict(bucket=1)):
        assert tdl.DroplessConfig(**kw).bucket_spec().key() == \
            jdl.DroplessConfig(**kw).bucket_spec().key()


def test_handle_rescale_and_step_stats():
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(ARCH)
    cache = TCache(max_entries=8)
    dm = tdl.make_moe_dropless(cfg, tdl.DroplessConfig(ep=2), cache=cache)
    with pytest.raises(ValueError, match="divisible"):
        tdl.make_moe_dropless(cfg, tdl.DroplessConfig(ep=4), cache=cache)
    with pytest.raises(ValueError, match="SwiGLU"):
        tdl.DroplessMoE(tdl.DroplessConfig(), act="gelu", cache=cache)
    small = dm.rescale(new_ep=1)
    assert small.cache is cache and small.dc.ep == 1
    assert cache.info()["active_ep"] == 1 and cache.rekeyed == 1
    with pytest.raises(NotImplementedError, match="elastic"):
        dm.rescale(dead_ranks=[1])
    with pytest.raises(ValueError):
        dm.rescale(new_ep=0)
    cache.record_rows(8, 12)
    assert dm.step_stats() == {"hits": 0, "misses": 0, "evictions": 0,
                               "entries": 0, "pad_ratio": 1.5}
    assert dm.step_stats()["pad_ratio"] == 1.0


def test_process_cache_is_shared_and_grows(fresh_process_caches):
    for mod in (jdl, tdl):
        a = mod.get_process_cache(8)
        assert mod.get_process_cache(16) is a and a.max_entries == 16
        assert mod.get_process_cache(4).max_entries == 16
        assert mod.DroplessMoE(mod.DroplessConfig()).cache is a


# ---------------------------------------------------------------------------
# Train steps on the smoke config.
# ---------------------------------------------------------------------------


def _smoke_cfgs(remat=False):
    from repro.configs import get_smoke_config as jsmoke
    from repro_torch.configs import get_smoke_config as tsmoke
    out = []
    for get in (jsmoke, tsmoke):
        c = get(ARCH)
        out.append(dataclasses.replace(
            c, n_layers=1, dtype="float32", remat=remat,
            moe=dataclasses.replace(c.moe, capacity_factor=8.0)))
    return out


BATCH = {"tokens": (np.arange(32, dtype=np.int32).reshape(2, 16) % 50),
         "labels": np.ones((2, 16), np.int32)}
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
DC = dict(ep=2, bucket=4)


def _ssc(m):
    return {k: float(v) for k, v in m.items() if k.startswith("ssc_")}


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX package's fixed-capacity step and two dropless steps on the
    1-layer smoke config, with and without remat — one JAX step function
    per case, built with the process cache swapped out."""
    from repro.launch import steps as St
    from repro.launch.mesh import make_test_mesh, mesh_context
    from repro.models import model as M
    from repro.optim import adamw
    mesh = make_test_mesh(data=1, model=1)
    batch = {k: jnp.asarray(v) for k, v in BATCH.items()}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for remat in (False, True):
            mp.setattr(jdl, "_PROCESS_CACHE", None)
            cfg = _smoke_cfgs(remat)[0]
            params = M.init_params(cfg, jax.random.PRNGKey(0))
            opt_state = adamw.init_opt_state(params)
            oc = adamw.OptConfig(**OPT)
            drop = St.make_steps(cfg, mesh, opt=oc, mode="zero1",
                                 dropless=jdl.DroplessConfig(**DC))
            with mesh_context(mesh):
                p2, o2, m2 = drop.train_step(params, opt_state, batch)
                _, _, m3 = drop.train_step(p2, o2, batch)
                fixed = None
                if not remat:
                    fixed = St.make_steps(cfg, mesh, opt=oc, mode="zero1")
                    _, _, fixed = fixed.train_step(params, opt_state, batch)
            out[remat] = {"params": jax.tree.map(np.asarray, params),
                          "opt_state": jax.tree.map(np.asarray, opt_state),
                          "p2": jax.tree.map(np.asarray, p2),
                          "losses": (float(m2["loss"]), float(m3["loss"])),
                          "ssc": (_ssc(m2), _ssc(m3)),
                          "fixed_loss": fixed and float(fixed["loss"])}
    return out


def _port_steps(jax_out, tcfg, dropless):
    from repro_torch.convert import (opt_state_from_numpy,
                                     train_params_from_numpy)
    from repro_torch.optim import adamw
    params = train_params_from_numpy(jax_out["params"], tcfg, "cpu")
    state = opt_state_from_numpy(jax_out["opt_state"], tcfg, "cpu")
    step = TSt.make_train_step(tcfg, adamw.OptConfig(**OPT),
                               dropless=dropless)
    batch = {k: torch.as_tensor(v, dtype=torch.long)
             for k, v in BATCH.items()}
    p2, state, m2 = step(params, state, batch)
    after_one = adamw.tree_map(lambda t: t.detach().clone(), p2)
    # The step updates params in place; the copy keeps step 1's.
    _, _, m3 = step(p2, state, batch) if dropless else (None, None, None)
    return step, after_one, m2, m3


def test_smoke_train_step_matches_jax_and_fixed_capacity(
        jax_steps, fresh_process_caches):
    """One-layer smoke config in fp32 at ``capacity_factor=8`` (nothing
    dropped): the port's dropless loss equals its fixed-capacity loss and
    JAX's dropless loss; the updated params equal JAX's; each step's
    ``ssc_*`` metrics equal JAX's (compile fwd + bwd, then all hits)."""
    from repro_torch.optim import adamw
    j = jax_steps[False]
    tcfg = _smoke_cfgs()[1]
    _, _, fixed, _ = _port_steps(j, tcfg, None)
    step, p2, m2, m3 = _port_steps(j, tcfg, tdl.DroplessConfig(**DC))
    assert step.dropless is not None
    assert step.dropless.cache is tdl._PROCESS_CACHE
    loss = float(m2["loss"])
    assert loss == pytest.approx(float(fixed["loss"]), rel=1e-5)
    assert loss == pytest.approx(j["losses"][0], rel=1e-5)
    assert float(m3["loss"]) == pytest.approx(j["losses"][1], rel=1e-5)
    assert j["fixed_loss"] == pytest.approx(loss, rel=1e-5)
    assert (_ssc(m2), _ssc(m3)) == j["ssc"]
    assert _ssc(m2)["ssc_misses"] == 2 and _ssc(m2)["ssc_entries"] == 2
    assert _ssc(m3)["ssc_misses"] == 0 and _ssc(m3)["ssc_hits"] == 2
    from repro_torch.convert import train_params_from_numpy
    want = adamw.tree_leaves(train_params_from_numpy(j["p2"], tcfg, "cpu"))
    got = adamw.tree_leaves(p2)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), **TOL)


def test_smoke_train_step_under_remat_pins_the_recompute_hit(
        jax_steps, fresh_process_caches):
    """With per-layer remat the port's checkpoint runs the fragment's
    forward again in the backward, a cache hit that JAX's remat of the
    custom-vjp fragment does not make: per layer and step the port counts
    one more hit; misses, entries and the loss are JAX's."""
    j = jax_steps[True]
    _, _, m2, m3 = _port_steps(j, _smoke_cfgs(True)[1],
                               tdl.DroplessConfig(**DC))
    assert float(m2["loss"]) == pytest.approx(j["losses"][0], rel=1e-5)
    got = [(s["ssc_hits"], s["ssc_misses"], s["ssc_entries"])
           for s in (_ssc(m2), _ssc(m3))]
    assert got == [(1, 2, 2), (3, 0, 2)]
    want = [(s["ssc_hits"], s["ssc_misses"], s["ssc_entries"])
            for s in j["ssc"]]
    assert want == [(0, 2, 2), (2, 0, 2)]


def test_train_main_dropless_on_cpu(fresh_process_caches, capsys):
    run = ttrain.main(["--smoke", "--device", "cpu", "--dropless",
                       "--dropless-ep", "2", "--dropless-bucket",
                       "geometric:8", "--sched", "auto", "--steps", "2",
                       "--seq", "16", "--global-batch", "2"])
    assert [m["step"] for m in run.metrics_log] == [0, 1]
    for m in run.metrics_log:
        assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
        assert m["peak_bytes"] is None and m["gmm_launches"] == 0
        assert {"ssc_hits", "ssc_misses", "ssc_entries",
                "ssc_pad_ratio"} <= set(m)
    assert run.dropless.dc.ep == 2 and run.dropless.dc.pipeline == "auto"
    assert run.metrics_log[0]["ssc_misses"] > 0
    out = capsys.readouterr().out
    assert "dropless SSC cache" in out and "geometric" in out


def test_train_main_dropless_needs_cuda_and_checks_its_flags(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--smoke", "--dropless", "--steps", "1"])
    for argv, msg in ((["--sched", "auto"], "add --dropless"),
                      (["--dropless", "--sched", "no_such_pass"],
                       "no_such_pass"),
                      (["--dropless", "--dropless-bucket", "bogus:1"],
                       "bogus")):
        with pytest.raises(SystemExit):
            ttrain.main(["--smoke", "--device", "cpu", *argv])
        assert msg in capsys.readouterr().err


def test_bench_dropless_holds_the_fragment_on_cpu():
    """The measurement script's checks at the smoke config's widths: the
    plain executor, the fixed-capacity layer, autograd of the plain
    fragment and the bit-equal recompute; no times off the card."""
    from repro_torch.launch import bench_dropless
    out = bench_dropless.main(["--device", "cpu", "--smoke", "--tokens",
                               "64", "--ep", "1,2"])
    assert out["device"] == "cpu" and out["fixed_capacity"] is None
    assert [r["ep"] for r in out["rows"]] == [1, 2]
    for r in out["rows"]:
        c = r["checks"]
        assert c["recompute_bit_equal"]
        assert c["tasks"]["forward"] > 0 and c["tasks"]["backward"] > 0
        assert "forward_ms" not in r
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bench_dropless.main(["--smoke"])
