"""The port's self-tuning serving (``repro_torch.launch.serve`` with
admission, ``--sched`` and ``OnlineMoE``) against the JAX package's, on the
CPU, at granite-moe's smoke config in fp32 (2 layers, ep = 2).

The JAX weights go through ``convert.params_from_numpy``. Decode
populations and the ``resolve_decode_sched`` reports are equal exactly (the
µs are the Ascend A3 cost model's predictions); the admit/defer/shed verdict
sequence and the shed list equal JAX's ``ContinuousBatcher``'s; greedy
tokens through ``OnlineMoE`` equal JAX's and a forced swap does not change
them, where the port's logits decide them by the margin of
``tests/_torch_margin.py`` (the logits everywhere within 1e-4). Every
``OnlineMoE`` gets its own ``SSCCache``; a module fixture asserts that
both packages' process-wide caches are left as they were.
"""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from _torch_margin import check_decisions, watch_batcher  # noqa: E402
import repro.core.autoselect as jsel  # noqa: E402
import repro.launch.dropless as jdl  # noqa: E402
import repro.launch.online as jon  # noqa: E402
import repro.launch.serve as jsv  # noqa: E402
import repro_torch.core.autoselect as tsel  # noqa: E402
import repro_torch.launch.dropless as tdl  # noqa: E402
import repro_torch.launch.online as ton  # noqa: E402
import repro_torch.launch.serve as tsv  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.core.ssc import SSCCache as JCache  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_smoke_config as tget_smoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.ssc import SSCCache as TCache  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
ARCH = "granite-moe-3b-a800m"
EP = 2                      # 6 experts at the smoke size: ep = 2


@pytest.fixture(scope="module", autouse=True)
def process_caches_untouched():
    before = {m: (m._PROCESS_CACHE, None if m._PROCESS_CACHE is None
                  else m._PROCESS_CACHE.info()) for m in (jdl, tdl)}
    yield
    for m, (cache, info) in before.items():
        assert m._PROCESS_CACHE is cache
        assert (None if cache is None else cache.info()) == info


@pytest.fixture(autouse=True)
def clear_selection_caches():
    jsel.selection_cache_clear()
    tsel.selection_cache_clear()


@pytest.fixture(scope="module")
def smoke():
    jcfg = dataclasses.replace(jget_smoke(ARCH), dtype="float32")
    tcfg = dataclasses.replace(tget_smoke(ARCH), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _prompts(cfg, n, length, seed=0):
    rng = np.random.default_rng(seed)
    return {i: rng.integers(0, cfg.vocab, length) for i in range(n)}


def test_decode_population_equal_jax(smoke):
    jcfg, tcfg, _, _ = smoke
    for ep, n, kw in ((EP, 4, {}), (EP, 6, dict(profile="bursty", seed=3)),
                      (1, 8, dict(steps=5))):
        want = jsv.decode_population(jcfg.moe, ep, n, **kw)
        got = tsv.decode_population(tcfg.moe, ep, n, **kw)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert tsv.serving_ep(tcfg.moe, 4, 16) == EP


@pytest.mark.parametrize("sched", ["auto", "ratr+crit",
                                   "ratr,gmm_interleave"])
def test_resolve_decode_sched_reports_equal_jax(smoke, sched, capsys):
    jcfg, tcfg, _, _ = smoke
    assert tsv.resolve_decode_sched(tcfg, sched, 4) == \
        jsv.resolve_decode_sched(jcfg, sched, 4)
    # From a live population, as main re-resolves after serving.
    pop = jsv.decode_population(jcfg.moe, EP, 4, profile="hotspot")
    plan_j = jon.population_plan(pop, total_rows=8)
    plan_t = ton.population_plan(pop, total_rows=8)
    assert tsv.resolve_decode_sched(tcfg, sched, 4, plan=plan_t) == \
        jsv.resolve_decode_sched(jcfg, sched, 4, plan=plan_j)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 4 and out[0] == out[1] and out[2] == out[3]
    dense = dataclasses.replace(tcfg, family="dense")
    assert tsv.resolve_decode_sched(dense, sched, 4) is None


def _jax_serve(b, prompts, max_new):
    """JAX's CLI loop, verdicts recorded."""
    pending, finished, verdicts = list(prompts), [], []
    while pending or b.active.any() or b.instant_done:
        while pending:
            v = b.offer(pending[0], prompts[pending[0]], max_new,
                        queue_depth=len(pending))
            verdicts.append((pending[0], v))
            if v == "defer":
                break
            pending.pop(0)
        finished += b.step()
    assert sorted(finished + b.shed) == sorted(prompts)
    return verdicts


def test_admission_verdicts_and_shed_equal_jax(smoke):
    """Four slots, 10 offers with max_queue 6 (the first four are shed),
    and an SLO at the predicted step of 2 busy slots, so admissions past
    two active slots defer: the same verdicts in the same order, the same
    shed ids and the same tokens."""
    jcfg, tcfg, jp, tp = smoke
    prompts = _prompts(jcfg, 10, 8)
    counts = jsv.decode_population(jcfg.moe, EP, 4)
    jb = jsv.ContinuousBatcher(jcfg, jp, n_slots=4, max_len=8 + 4 + 1,
                               decode_counts=counts)
    slo = jb._predict_step_us(2)
    assert jb._predict_step_us(3) > slo
    jb.admission = jon.AdmissionConfig(slo_us=slo, max_queue=6)
    want = _jax_serve(jb, prompts, 4)
    assert tsv.predict_step_us(tcfg, counts, 2) == slo
    tb, stats = tsv.serve(tcfg, tp, prompts, n_slots=4, max_new=4,
                          device="cpu", decode_counts=counts,
                          admission=ton.AdmissionConfig(slo_us=slo,
                                                        max_queue=6))
    assert stats["verdicts"] == want
    assert tb.shed == jb.shed == [0, 1, 2, 3]
    assert stats["deferred"] == jb.deferred > 0
    assert stats["requests"] + stats["shed"] == 10
    assert tb.generated == jb.generated
    # No gate: admit or defer on slots only, nothing shed.
    tb2, stats2 = tsv.serve(tcfg, tp, prompts, n_slots=4, max_new=4,
                            device="cpu")
    assert stats2["shed"] == 0 and stats2["requests"] == 10
    assert {v for _, v in stats2["verdicts"]} == {"admit", "defer"}


def _serve_online(m, cfg, params, prompts, max_new, swap_at, cache,
                  forced=None):
    """Serve through ``OnlineMoE`` (ep = 2, ``geometric:8``, refits off)
    with the reference test's loop, a forced swap after ``swap_at``
    decode steps, fed ``forced`` tokens where given (``watch_batcher``);
    returns the greedy tokens, the tuner and each decision's logits."""
    dl = jdl if m is jsv else tdl
    on = jon if m is jsv else ton
    tuner = on.OnlineTuner(initial="geometric:8",
                           oc=on.OnlineConfig(refit_every=10_000),
                           d_model=cfg.d_model, d_ff=cfg.moe.d_expert)
    om = on.OnlineMoE(dl.DroplessConfig(ep=EP, bucket=tuner.spec,
                                        pipeline=("ratr",)), tuner,
                      cache=cache)
    kw = {} if m is jsv else {"device": "cpu"}
    b = m.ContinuousBatcher(cfg, params, n_slots=2,
                            max_len=12 + max_new + 1, moe_impl=om.impl,
                            **kw)
    pending, finished, steps = list(prompts), [], 0
    with torch.no_grad(), watch_batcher(b, forced) as logs:
        while pending or b.active.any() or b.instant_done:
            while pending and b.admit(pending[0], prompts[pending[0]],
                                      max_new):
                pending.pop(0)
            finished += b.step()
            steps += 1
            if steps == swap_at:
                om.swap_to("linear:4")
            assert steps < 200
    assert sorted(finished) == sorted(prompts)
    return b.generated, tuner, logs


def test_online_greedy_tokens_equal_jax_and_survive_a_forced_swap(smoke):
    """The port serves first, without a swap; its tokens are fed to the
    other three runs (JAX's, and both packages' with the swap), so all
    four decide on the same inputs at each of the 16 decisions, the two
    refilled requests' included. Each run's logits are held to the port's
    within 1e-4, and its tokens equal the port's exactly where the port's
    top-1/top-2 gap is at least MARGIN of the logits' range. At least 13
    decisions, and every token of a refilled request, must be compared
    exactly."""
    jcfg, tcfg, jp, tp = smoke
    prompts = _prompts(jcfg, 4, 12, seed=1)
    tokens, _, ref = _serve_online(tsv, tcfg, tp, prompts, 4, None,
                                   TCache(max_entries=64))
    tuners = {}
    for m, cfg, params, Cache in ((jsv, jcfg, jp, JCache),
                                  (tsv, tcfg, tp, TCache)):
        for swap_at in (None, 2) if m is jsv else (2,):
            got, tuners[m, swap_at], logs = _serve_online(
                m, cfg, params, prompts, 4, swap_at, Cache(max_entries=64),
                forced=tokens)
            assert got == tokens
            exact = check_decisions(ref, logs, tokens, tol=1e-4)
            assert sum(exact.values()) >= 13, (m.__name__, swap_at, exact)
            assert any(exact[rid] == 4 for rid in (2, 3)), exact
    assert tuners[tsv, 2].swaps == tuners[jsv, 2].swaps
    assert tuners[tsv, 2].swaps[-1]["forced"]


def test_serve_main_with_every_scheduling_option_on_the_cpu(monkeypatch,
                                                            capsys):
    monkeypatch.setattr(tdl, "_PROCESS_CACHE", None)
    b, stats = tsv.main(["--smoke", "--device", "cpu", "--sched", "auto",
                         "--online-refit", "--slo-us", "40",
                         "--max-queue", "5", "--requests", "8",
                         "--slots", "4", "--prompt-len", "8",
                         "--max-new", "3"])
    rep = stats["report"]
    assert stats["requests"] + stats["shed"] == 8 and stats["shed"] == 3
    assert b.shed == [0, 1, 2]
    assert rep["ep"] == EP and rep["online"]["steps"] > 0
    assert rep["sched"]["tag"] and rep["sched_live"]["tag"]
    assert rep["cache"]["misses"] > 0 and stats["nonfinite_steps"] == 0
    assert rep["admission"]["n_slots"] == 4
    out = capsys.readouterr().out
    assert "online tuner:" in out and "3 shed" in out


def test_serve_main_refuses_a_bad_sched(capsys):
    with pytest.raises(SystemExit) as e:
        tsv.main(["--smoke", "--device", "cpu", "--sched", "no_such_pass"])
    assert e.value.code == 2
    assert "no_such_pass" in capsys.readouterr().err


def test_serve_online_phase_cases_run_on_the_cpu(monkeypatch):
    """Phase 13's checks at the smoke config's widths on the CPU: the
    fragment under three specs (padding differently, within rounding of
    one another here; bit-equal is the card's gate), the forced swap with
    identical tokens, and the online prefill against the plain FFN."""
    cfg = tget_smoke(ARCH)
    fcfg = dataclasses.replace(cfg, dtype="float32")
    frag = chip_smoke.fragment_bits_case(fcfg, tokens=8, dev="cpu")
    assert frag["ep"] == EP and len(set(frag["plan_rows"].values())) > 1
    assert frag["max_gap"] < 1e-5
    assert all(c["plain_executor"] < 1e-5 for c in frag["checks"].values())
    swap = chip_smoke.forced_swap_case(fcfg, requests=4, prompt_len=8,
                                       max_new=4, dev="cpu")
    assert swap["tokens_identical"] and swap["forced_swaps"] == 1
    monkeypatch.setattr(chip_smoke, "PROMPT_LEN", 16)
    pre = chip_smoke.online_prefill_case(cfg, dev="cpu")
    assert pre["finite"] and pre["logit_max_abs_err"] <= \
        chip_smoke.LOGIT_TOL * pre["logit_max_abs"]
