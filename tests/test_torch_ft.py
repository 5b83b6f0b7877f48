"""The port's fault-tolerant training loop (``repro_torch.ft.runner``), its
chaos harness (``repro_torch.ft.harness``) and ``train --ckpt-dir`` against
the JAX package, on the CPU.

Every test writes under its own ``tmp_path``. No test sets an environment
variable or reads a wall clock: the straggler test puts a fake clock in
place of both runners' ``time`` through ``monkeypatch``, and the harness
tests record runs and share params the same way.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import ftharness  # noqa: E402
import repro.ft.runner as jrunner  # noqa: E402
import repro_torch.ft.harness as tharness  # noqa: E402
import repro_torch.ft.runner as trunner  # noqa: E402
from repro.core import routing as jrouting  # noqa: E402
from repro.core.odg import ScheduleConfig as JSchedCfg  # noqa: E402
from repro.core.ssc import SSCCache as JCache  # noqa: E402
from repro_torch.checkpoint import ckpt as CK  # noqa: E402
from repro_torch.core import routing as trouting  # noqa: E402
from repro_torch.core.elastic import check_remap, remap_plan  # noqa: E402
from repro_torch.core.odg import ScheduleConfig as TSchedCfg  # noqa: E402
from repro_torch.core.ssc import SSCCache as TCache  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402

CKPT_EVERY = 3
N_STEPS = 7


# ---------------------------------------------------------------------------
# The reference's fake step, in both packages (tests/test_ft_restart.py).
# ---------------------------------------------------------------------------


class _JStream:
    def sharded_batch(self, step, mesh, sharding):
        return jnp.float32(step + 1)


class _TStream:
    def sharded_batch(self, step, mesh, device):
        return torch.tensor(step + 1, dtype=torch.float32)


def _jstep(params, opt_state, batch):
    w = params["w"] - 0.01 * batch
    return ({"w": w}, opt_state,
            {"loss": jnp.sum(w * w), "grad_norm": jnp.float32(0.1)})


def _tstep(params, opt_state, batch):
    w = params["w"] - 0.01 * batch
    return ({"w": w}, opt_state,
            {"loss": torch.sum(w * w), "grad_norm": torch.tensor(0.1)})


def _bomb_at(k):
    armed = {"on": True}

    def inject(step):
        if armed["on"] and step == k:
            armed["on"] = False
            raise RuntimeError(f"injected fault at step {k}")
    return inject


def _jrun(tmp, n_steps=N_STEPS, inject=None, step_fn=_jstep, **ftkw):
    ft = jrunner.FTConfig(ckpt_dir=str(tmp), ckpt_every=CKPT_EVERY, **ftkw)
    return jrunner.train_loop(
        step_fn=step_fn, params={"w": jnp.float32(1.0)}, opt_state=None,
        stream=_JStream(), mesh=None, batch_sharding=None, n_steps=n_steps,
        ft=ft, inject_fault=inject, log_every=1)


def _trun(tmp, n_steps=N_STEPS, inject=None, step_fn=_tstep, **ftkw):
    ft = trunner.FTConfig(ckpt_dir=str(tmp), ckpt_every=CKPT_EVERY, **ftkw)
    return trunner.train_loop(
        step_fn=step_fn, params={"w": torch.tensor(1.0)}, opt_state=None,
        stream=_TStream(), mesh=None, device="cpu", n_steps=n_steps, ft=ft,
        inject_fault=inject, log_every=1)


def _log(run):
    return [(m["step"], m["loss"], m["grad_norm"]) for m in run.metrics_log]


@pytest.mark.parametrize("k", range(1, N_STEPS))
def test_kill_at_every_step_equals_the_reference(k, tmp_path):
    """A crash before step ``k`` resumes from the newest checkpoint at or
    below it; the merged log and the final ``w`` equal a never-failed run's
    and the reference's, bit for bit."""
    runs = {}
    for name, run in (("port", _trun), ("jax", _jrun)):
        base = run(tmp_path / name / "base")
        with pytest.raises(RuntimeError, match="injected"):
            run(tmp_path / name / "ft", inject=_bomb_at(k))
        runs[name] = (base, run(tmp_path / name / "ft"))
    (tbase, tres), (jbase, jres) = runs["port"], runs["jax"]
    expect = (k // CKPT_EVERY) * CKPT_EVERY if k >= CKPT_EVERY else None
    assert tres.resumed_from == jres.resumed_from == expect
    assert tres.step == jres.step == N_STEPS
    assert [m["step"] for m in tres.metrics_log] == list(range(1, 8))
    assert _log(tres) == _log(tbase) == _log(jres) == _log(jbase)
    assert torch.equal(tres.params["w"], tbase.params["w"])
    assert float(tres.params["w"]) == float(np.asarray(jres.params["w"]))


class _Clock:
    """A fake wall clock that only the step advances."""

    def __init__(self):
        self.now = 1000.0

    def time(self):
        return self.now


def test_straggler_log_survives_crash_equals_the_reference(tmp_path,
                                                           monkeypatch):
    """A 0.4 s stall at step 1 (pre-crash, pre-checkpoint) is still in the
    resumed run's straggler log: it rides the step-3 manifest. Both
    packages' runners read the same fake clock."""
    clock = _Clock()
    monkeypatch.setattr(trunner, "time", clock)
    monkeypatch.setattr(jrunner, "time", clock)

    def slow(step_fn):
        def step(params, opt_state, batch):
            clock.now += 0.4 if float(batch) == 2.0 else 0.01
            return step_fn(params, opt_state, batch)
        return step

    out = {}
    for name, run, step_fn in (("port", _trun, _tstep),
                               ("jax", _jrun, _jstep)):
        with pytest.raises(RuntimeError, match="injected"):
            run(tmp_path / name, inject=_bomb_at(5), step_fn=slow(step_fn),
                straggler_factor=1.5)
        out[name] = run(tmp_path / name, step_fn=slow(step_fn),
                        straggler_factor=1.5)
    tres, jres = out["port"], out["jax"]
    assert tres.resumed_from == jres.resumed_from == 3
    assert any(s[0] == 1 for s in tres.stragglers), tres.stragglers
    assert tres.stragglers == jres.stragglers
    assert [m["step"] for m in tres.metrics_log] == list(range(1, 8))
    assert [m["step_time_s"] for m in tres.metrics_log] == \
        [m["step_time_s"] for m in jres.metrics_log]


# ---------------------------------------------------------------------------
# Elastic rescale on restore (tests/test_elastic.py:339-423), both packages.
# ---------------------------------------------------------------------------


def _rank_step(lib, ep):
    def step(params, opt_state, batch):
        w = params["w"] - 0.01 * batch
        total = jnp.sum(w * w) if lib == "jax" else torch.sum(w * w)
        return ({"w": w}, opt_state,
                {"loss": total, "grad_norm": 0.1,
                 "rank_time_us": np.r_[np.full(ep - 1, 100.0), 300.0]})
    return step


_PKG = {
    "jax": dict(runner=jrunner, routing=jrouting, cache=JCache,
                cfg=JSchedCfg, stream=_JStream, w=lambda: jnp.float32(1.0),
                loop_kw=lambda: {"batch_sharding": None}),
    "port": dict(runner=trunner, routing=trouting, cache=TCache,
                 cfg=TSchedCfg, stream=_TStream,
                 w=lambda: torch.tensor(1.0),
                 loop_kw=lambda: {"device": "cpu"}),
}


def _elastic_sequence(lib, tmp):
    P = _PKG[lib]
    R = P["runner"]
    plan = P["routing"].skewed_plan(3, 2, 8, alpha=1.0)
    cache = P["cache"](8)
    cache.get_or_compile(
        P["cfg"](ep=plan.ep, e_loc=plan.e_loc, rows=0, d_model=8, d_ff=4,
                 plan=plan, bucket=4), "forward", pipeline=["ratr"])
    ft = R.FTConfig(ckpt_dir=str(tmp), ckpt_every=2)

    def loop(ep, n_steps, elastic):
        return R.train_loop(step_fn=_rank_step(lib, ep),
                            params={"w": P["w"]()}, opt_state=None,
                            stream=P["stream"](), mesh=None,
                            n_steps=n_steps, ft=ft, log_every=1,
                            elastic=elastic, **P["loop_kw"]())

    run3 = loop(3, 4, R.ElasticContext(ep=3, cache=cache,
                                       plans={"live": plan}))
    elastic2 = R.ElasticContext(ep=2, cache=cache, dead_ranks=(1,))
    run2 = loop(2, 6, elastic2)
    elastic3 = R.ElasticContext(ep=3, cache=cache)
    run4 = loop(3, 8, elastic3)
    return {"plan": plan, "run3": run3, "run2": run2, "run4": run4,
            "remapped": elastic2.plans["live"],
            "grown": elastic3.plans["live"], "cache": cache.info()}


def test_train_loop_elastic_rescale_on_restore_equals_the_reference(
        tmp_path):
    t = _elastic_sequence("port", tmp_path / "port")
    j = _elastic_sequence("jax", tmp_path / "jax")
    assert t["plan"].counts == j["plan"].counts
    assert t["run3"].rank_time_ewma == j["run3"].rank_time_ewma
    assert len(t["run3"].rank_time_ewma) == 3
    assert t["run2"].resumed_from == j["run2"].resumed_from == 4
    assert t["run2"].step == 6
    assert t["remapped"].counts == j["remapped"].counts == \
        remap_plan(t["plan"], dead_ranks=[1]).counts
    assert check_remap(t["plan"], t["remapped"], (0, 2))["ok"]
    assert t["run2"].elastic_events == j["run2"].elastic_events
    (event,) = t["run2"].elastic_events
    assert event["survivors"] == [0, 2] and event["cache"]["entries"] == 1
    assert t["run2"].rank_time_ewma == j["run2"].rank_time_ewma
    assert t["run2"].cost_model().rank_bias == \
        j["run2"].cost_model().rank_bias
    assert len(t["run2"].cost_model().rank_bias) == 2
    assert _log(t["run2"]) == _log(j["run2"])
    assert [m["step"] for m in t["run2"].metrics_log] == list(range(1, 7))
    assert t["run4"].elastic_events == j["run4"].elastic_events
    assert t["grown"].counts == j["grown"].counts
    assert t["grown"].ep == 3
    assert t["grown"].total_rows == t["remapped"].total_rows
    for k in ("active_ep", "evictions", "rekeyed", "entries", "by_ep"):
        assert t["cache"][k] == j["cache"][k], k


def test_runstate_cost_model_without_observations():
    kw = dict(step=0, params=None, opt_state=None, metrics_log=[],
              stragglers=[])
    assert trunner.RunState(**kw).cost_model().rank_bias is None
    assert repr(trunner.RunState(**kw).cost_model()) == \
        repr(jrunner.RunState(**kw).cost_model())


def test_dead_ranks_mismatch_raises_as_the_reference(tmp_path):
    msgs = {}
    for lib in ("port", "jax"):
        P = _PKG[lib]
        R = P["runner"]
        ft = R.FTConfig(ckpt_dir=str(tmp_path / lib), ckpt_every=2)
        kw = dict(params={"w": P["w"]()}, opt_state=None,
                  stream=P["stream"](), mesh=None, ft=ft, **P["loop_kw"]())
        R.train_loop(step_fn=_rank_step(lib, 3), n_steps=2,
                     elastic=R.ElasticContext(ep=3), **kw)
        with pytest.raises(ValueError, match="survivors") as e:
            R.train_loop(step_fn=_rank_step(lib, 2), n_steps=4,
                         elastic=R.ElasticContext(ep=2, dead_ranks=(0, 1)),
                         **kw)
        msgs[lib] = str(e.value)
    assert msgs["port"] == msgs["jax"]


def test_ftconfig_has_no_default_directory():
    with pytest.raises(TypeError):
        trunner.FTConfig()
    port, ref = trunner.FTConfig(ckpt_dir="d"), jrunner.FTConfig()
    for k in ("ckpt_every", "keep", "straggler_factor", "ewma_alpha"):
        assert getattr(port, k) == getattr(ref, k), k


# ---------------------------------------------------------------------------
# The chaos harness twin, against tests/ftharness.py.
# ---------------------------------------------------------------------------


def _shared_params(profile, seed=0, device="cpu"):
    """The reference harness's params, as the port's tensors."""
    return {k: torch.from_numpy(np.array(v))
            for k, v in ftharness.make_params(profile, seed).items()}


def _recorder(mod, store):
    loop = mod._loop

    def recording(*a, **kw):
        run = loop(*a, **kw)
        store.append(run)
        return run
    return recording


@pytest.mark.parametrize("kind, profile", [("kill", "uniform"),
                                           ("rescale", "hotspot")])
def test_harness_cell_equals_the_reference(kind, profile, tmp_path,
                                           monkeypatch):
    """Same params, same data: equal check dicts, and every completed
    run's loss trajectory within 1e-5 of the reference's."""
    runs = {"port": [], "jax": []}
    monkeypatch.setattr(tharness, "make_params", _shared_params)
    monkeypatch.setattr(tharness, "_loop", _recorder(tharness, runs["port"]))
    monkeypatch.setattr(ftharness, "_loop",
                        _recorder(ftharness, runs["jax"]))
    fn = {"kill": "run_kill", "rescale": "run_rescale"}[kind]
    port = getattr(tharness, fn)(profile, str(tmp_path / "port"),
                                 device="cpu")
    ref = getattr(ftharness, fn)(profile, str(tmp_path / "jax"))
    assert port == {k: bool(v) for k, v in ref.items()}
    assert all(port.values()), port
    assert len(runs["port"]) == len(runs["jax"]) >= 1
    for t, j in zip(runs["port"], runs["jax"]):
        assert t.resumed_from == j.resumed_from
        tl, jl = np.array(_log(t)), np.array(_log(j))
        assert tl.shape == jl.shape
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
        for a, b in zip(tree_leaves(t.params),
                        jax.tree.leaves(j.params)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", tharness.KINDS)
@pytest.mark.parametrize("profile", tharness.PROFILES)
def test_harness_cell_passes(kind, profile, tmp_path):
    checks = tharness.run_scenario(kind, profile, str(tmp_path),
                                   device="cpu")
    assert checks and all(checks.values()), checks


def test_harness_cli(tmp_path, capsys):
    assert tharness.main(["--kinds", "slow", "--profiles", "hotspot",
                          "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and '"ok": true' in lines[0]
    with pytest.raises(SystemExit):
        tharness.main(["--kinds", "nope", "--device", "cpu"])


# ---------------------------------------------------------------------------
# train --ckpt-dir on the CPU.
# ---------------------------------------------------------------------------

_TRAIN = ["--smoke", "--device", "cpu", "--steps", "5", "--seq", "16",
          "--global-batch", "2", "--ckpt-every", "2"]


def test_train_main_crash_and_resume_equal_an_uninterrupted_run(tmp_path):
    base = ttrain.main(_TRAIN + ["--ckpt-dir", str(tmp_path / "base")])
    assert base.resumed_from is None
    with pytest.raises(RuntimeError, match="injected"):
        ttrain.main(_TRAIN + ["--ckpt-dir", str(tmp_path / "ft")],
                    inject_fault=_bomb_at(3))
    run = ttrain.main(_TRAIN + ["--ckpt-dir", str(tmp_path / "ft")])
    assert run.resumed_from == 2
    assert [m["step"] for m in run.metrics_log] == [0, 1, 2, 3, 4]
    assert _log(run) == _log(base)
    assert run.opt_state["step"] == base.opt_state["step"] == 5
    for a, b in zip(tree_leaves((base.params, base.opt_state)),
                    tree_leaves((run.params, run.opt_state))):
        if isinstance(a, int):
            assert a == b
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)
    # Saved at 2, 4 and the last step; the newest 3 kept, in the JAX
    # package's layout (stacked [L, ...] leaves, an int32 step).
    assert sorted(d for d in os.listdir(tmp_path / "ft")
                  if d.startswith("step_")) == [
        "step_00000002", "step_00000004", "step_00000005"]
    _, manifest = CK.restore(CK.latest_step_dir(str(tmp_path / "ft")), None)
    assert manifest["leaves"]["1/step"]["dtype"] == "int32"
    assert manifest["leaves"]["0/blocks/moe/w_in"]["shape"][0] == 2


def test_train_main_checkpoint_restores_in_the_jax_package(tmp_path):
    """The port's training checkpoint restores into the JAX launcher's
    ``(params, opt_state)`` bit for bit."""
    from repro.checkpoint import ckpt as JCK
    from repro.configs import get_smoke_config
    from repro.models import model as JM
    from repro.optim import adamw as jadamw
    run = ttrain.main(_TRAIN + ["--ckpt-dir", str(tmp_path)])
    jcfg = get_smoke_config("granite-moe-3b-a800m")
    jp = jadamw.cast_params(JM.init_params(jcfg, jax.random.PRNGKey(0)),
                            jcfg.compute_dtype)
    (params, state), manifest = JCK.restore(
        JCK.latest_step_dir(str(tmp_path)), (jp, jadamw.init_opt_state(jp)))
    assert manifest["step"] == 5 and int(state["step"]) == 5
    blk = params["blocks"]["moe"]["w_in"]
    assert blk.dtype == jnp.bfloat16
    for i in range(2):
        want = run.params["blocks"][i]["moe"]["w_in"]
        got = np.asarray(blk[i]).view(np.uint16)
        assert (want.view(torch.int16).numpy().view(np.uint16) == got).all()
    np.testing.assert_array_equal(
        np.asarray(state["master"]["embed"]),
        run.opt_state["master"]["embed"].numpy())
