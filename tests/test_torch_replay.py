"""The port's decode-trace replay (``repro_torch.launch.replay``),
``parallel.ep.ring_chunk_caps`` and the replay benchmark twin
(``repro_torch.launch.bench_replay``) against the JAX package's, on the
CPU.

Traces are equal array for array (the same numpy call sequence), JSONL
written by one package reads in the other, and replay rows are equal in
every field but ``fetch_us_mean``, which is this host's wall clock. Every
replay builds its own ``SSCCache``, so the JAX package's process-wide cache
is never touched; a module fixture asserts it.
"""

import contextlib
import io
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import repro.core.autoselect as jsel  # noqa: E402
import repro.launch.dropless as jdl  # noqa: E402
import repro.launch.replay as jrp  # noqa: E402
import repro.parallel.ep as jep  # noqa: E402
import repro_torch.core.autoselect as tsel  # noqa: E402
import repro_torch.launch.dropless as tdl  # noqa: E402
import repro_torch.launch.replay as trp  # noqa: E402
import repro_torch.parallel.ep as tep  # noqa: E402
from benchmarks import bench_replay as jbr  # noqa: E402
from repro.core.hardware import Topology as JTopo  # noqa: E402
from repro.core.routing import RoutingPlan as JPlan  # noqa: E402
from repro.models.moe import MoEConfig as JMC  # noqa: E402
from repro_torch.core.hardware import Topology as TTopo  # noqa: E402
from repro_torch.core.routing import RoutingPlan as TPlan  # noqa: E402
from repro_torch.launch import bench_replay as tbr  # noqa: E402
from repro_torch.models.moe import MoEConfig as TMC  # noqa: E402

EP, E_LOC, K = 4, 2, 2
JMC_, TMC_ = (JMC(n_experts=EP * E_LOC, top_k=K, d_expert=16),
              TMC(n_experts=EP * E_LOC, top_k=K, d_expert=16))


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
    """The selector memoizes per process; both sides start cold."""
    jsel.selection_cache_clear()
    tsel.selection_cache_clear()


def _untimed(rows):
    return [{k: v for k, v in r.items() if k != "fetch_us_mean"}
            for r in rows]


@pytest.mark.parametrize("profile", trp.PROFILES)
def test_synth_traces_and_arrivals_equal_jax(profile):
    for kw in (dict(ep=4, e_loc=2, t_loc=16, top_k=2, seed=0),
               dict(ep=2, e_loc=3, t_loc=5, top_k=3, seed=7, churn=0.5)):
        want = jrp.synth_trace(profile, 12, **kw)
        got = trp.synth_trace(profile, 12, **kw)
        assert len(got) == len(want) == 12
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            trp.synth_arrival_us(got, mean_gap_us=250.0, seed=3),
            jrp.synth_arrival_us(want, mean_gap_us=250.0, seed=3))
    with pytest.raises(ValueError, match="unknown profile"):
        trp.synth_trace("nope", 2)


def test_jsonl_written_by_one_package_reads_in_the_other(tmp_path):
    trace = jrp.synth_trace("bursty", 6, ep=2, e_loc=2, t_loc=4, seed=1)
    arr = jrp.synth_arrival_us(trace, mean_gap_us=100.0)
    for writer, reader in ((jrp, trp), (trp, jrp)):
        for arrivals in (None, arr):
            path = tmp_path / f"{writer.__name__}-{arrivals is None}.jsonl"
            writer.save_trace_jsonl(str(path), trace, arrival_us=arrivals)
            got, got_arr = reader.load_trace_jsonl(str(path),
                                                   with_arrivals=True)
            for a, b in zip(got, trace):
                np.testing.assert_array_equal(a, b)
            if arrivals is None:
                assert got_arr is None
            else:
                np.testing.assert_array_equal(got_arr, arrivals)
            assert [t.tolist() for t in reader.load_trace_jsonl(
                str(path))] == [t.tolist() for t in trace]
        with pytest.raises(ValueError, match="arrival_us has 2 entries"):
            writer.save_trace_jsonl(str(tmp_path / "bad.jsonl"), trace,
                                    arrival_us=arr[:2])
    (tmp_path / "empty.jsonl").write_text("\n")
    for m in (jrp, trp):
        with pytest.raises(ValueError, match="empty trace"):
            m.load_trace_jsonl(str(tmp_path / "empty.jsonl"))


def _caps_plans():
    rng = np.random.default_rng(5)
    for ep in (2, 4, 8):
        c = rng.integers(0, 9, (ep, ep, 3))
        c[0, ep - 1] = 0                 # a zero cell: its cap may be 0
        yield ep, c


@pytest.mark.parametrize("kw", [
    dict(),
    dict(bucket="linear:4"),
    dict(topo=2, bucket="geometric:2", inter_bucket="linear:8"),
    dict(topo=4, bucket=None, inter_bucket=16),
])
def test_ring_chunk_caps_equal_jax(kw):
    kw = dict(kw)
    rpn = kw.pop("topo", None)
    for ep, c in _caps_plans():
        if rpn is not None and ep % rpn:
            continue
        jt = JTopo(ranks_per_node=rpn) if rpn else None
        tt = TTopo(ranks_per_node=rpn) if rpn else None
        assert tep.ring_chunk_caps(TPlan.from_counts(c), ep, tt, **kw) == \
            jep.ring_chunk_caps(JPlan.from_counts(c), ep, jt, **kw)
    c = np.ones((2, 2, 1), np.int64)
    for m, P in ((jep, JPlan), (tep, TPlan)):
        with pytest.raises(ValueError, match="plan ep=2 != mesh ep=4"):
            m.ring_chunk_caps(P.from_counts(c), 4)
        with pytest.raises(ValueError, match="inter_bucket needs"):
            m.ring_chunk_caps(P.from_counts(c), 2, inter_bucket=4)


def test_replay_rows_equal_jax_but_for_the_wall_clock():
    """Static, fitted and online policies on one churned trace, with
    arrivals and an SLO: every row field but ``fetch_us_mean`` equal,
    including the simulator's latencies and the online tuner's swaps."""
    kw = dict(ep=EP, e_loc=E_LOC, top_k=K)
    trace = (jrp.synth_trace("zipf", 10, t_loc=12, seed=0, **kw)
             + jrp.synth_trace("zipf", 14, t_loc=24, seed=2, **kw))
    fit = jrp.synth_trace("zipf", 8, t_loc=12, seed=1, **kw)
    arr = jrp.synth_arrival_us(trace, mean_gap_us=5.0)
    names = ["exact", "linear:16", "geometric:4", "fitted:4", "online:4",
             "online:3x2"]
    rows = {}
    for m, mc in ((jrp, JMC_), (trp, TMC_)):
        pols = m.resolve_policies(names, fit, mc, EP)
        assert pols["online:4"].spec.key() == pols["fitted:4"].key()
        rows[m] = m.replay_trace(trace, mc, EP, pols, d_model=32, d_ff=16,
                                 arrival_us=arr, slo_us=8.0)
    assert _untimed(rows[trp]) == _untimed(rows[jrp])
    online = rows[trp][-1]
    assert online["refits"] == 3 and "slo_miss_rate" in online
    for m in (jrp, trp):
        with pytest.raises(ValueError, match="no bucket policies"):
            m.resolve_policies([" "], fit, JMC_ if m is jrp else TMC_, EP)
        with pytest.raises(ValueError, match="arrival_us has"):
            m.replay_trace(trace, JMC_ if m is jrp else TMC_, EP,
                           {"exact": "exact"}, arrival_us=arr[:3])


def test_replay_main_reports_equal_jax(tmp_path):
    """The CLI on a synthetic bursty profile with fitted and online
    policies, arrivals and an SLO: the report rows are equal but for the
    wall clock, and the trace it records is the same file."""
    out = {}
    for m in (jrp, trp):
        d = tmp_path / m.__name__
        d.mkdir()
        argv = ["--profile", "bursty", "--steps", "10", "--t-loc", "8",
                "--policies", "exact,linear:8,fitted:3,online:3",
                "--arrival-gap-us", "3", "--slo-us", "6",
                "--trace-out", str(d / "t.jsonl"),
                "--report-out", str(d / "r.jsonl")]
        with contextlib.redirect_stdout(io.StringIO()):
            out[m] = m.main(argv)
        assert len(out[m]) == 4
    assert _untimed(out[trp]) == _untimed(out[jrp])
    assert ((tmp_path / trp.__name__ / "t.jsonl").read_text()
            == (tmp_path / jrp.__name__ / "t.jsonl").read_text())
    # A recorded trace replays its held-out half under fitted policies.
    for m in (jrp, trp):
        with contextlib.redirect_stdout(io.StringIO()):
            rows = m.main(["--trace-in", str(tmp_path / trp.__name__ /
                                             "t.jsonl"),
                           "--policies", "fitted:2", "--no-sim"])
        assert rows[0]["steps"] == 5 and "p50_us" not in rows[0]


def _lines(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return buf.getvalue().splitlines(), out


def test_bench_replay_rows_equal_jax_but_for_the_times():
    """Both scripts at their own sizes: every row's name and derived text
    equal, and the admission row's predicted p99 too (the replay rows'
    ``us_per_call`` is the host's wall clock per fetch)."""
    want, _ = _lines(jbr.run)
    got, rows = _lines(tbr.run)
    split = [ln.split(",", 2) for ln in got]
    assert [(a, c) for a, _, c in split] == [
        (ln.split(",", 2)[0], ln.split(",", 2)[2]) for ln in want]
    assert got[-1] == want[-1]
    assert [r[0] for r in rows][-4:] == [
        "replay_churn_zipf_online", "replay_churn_hotspot_online",
        "replay_churn_bursty_online", "replay_admission_gated"]


def test_bench_replay_gate_raises(monkeypatch):
    """An unreachable admission gate refuses in the port's script."""
    monkeypatch.setattr(tbr, "run_online_gate", lambda: [])
    monkeypatch.setattr(tbr, "STEPS", 4)
    monkeypatch.setattr(tbr, "replay_admission",
                        lambda *a, **k: dict(served=0, shed=0, deferred=0,
                                             max_active=0, p99_us=1.0,
                                             slo_miss_rate=0.0))
    with pytest.raises(RuntimeError):
        _lines(tbr.run)
