"""The port's six simulator benchmark twins and their runner
(``repro_torch.launch.bench_{moe_ffn,step,autoselect,imbalance,
sched_overhead,topology}``, ``bench_run``) and the bucket-policy twin
(``bench_dropless_buckets``) against the reference's (``benchmarks/``), on
the CPU.

Their rows are the simulator's makespans on the Ascend A3 model, so they
must equal the reference's line for line; ``autoselect`` and the
bucket-policy replay time host code, and their rows must equal the
reference's but for the times. No test holds a
time to a budget (the scripts do; the tests lift autoselect's budgets,
and set them to 0 to test the gates). Where the reference loops over a
literal (``moe_ffn`` and ``step``: ep in (4, 8, 16)), the port's loop is a
module constant cut here to ep = 4, and the reference's rows at ep = 4 are
built from its own ``benchmarks/common.py`` helpers.
"""

import contextlib
import io
import pathlib
import re
import sys

import pytest

pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmarks import bench_autoselect as jba  # noqa: E402
from benchmarks import bench_dropless as jbd  # noqa: E402
from benchmarks import bench_imbalance as jbi  # noqa: E402
from benchmarks import bench_moe_ffn as jbm  # noqa: E402
from benchmarks import bench_sched_overhead as jbo  # noqa: E402
from benchmarks import bench_step as jbs  # noqa: E402
from benchmarks import bench_topology as jbt  # noqa: E402
from benchmarks import common as jc  # noqa: E402
from benchmarks import run as jrun  # noqa: E402
from repro.core.hardware import AscendA3 as JA3  # noqa: E402
from repro.core.simulator import simulate_baseline as jbase  # noqa: E402
from repro.core.simulator import simulate_unified as juni  # noqa: E402
from repro_torch.launch import bench_autoselect as tba  # noqa: E402
from repro_torch.launch import bench_dropless_buckets as tbd  # noqa: E402
from repro_torch.launch import bench_imbalance as tbi  # noqa: E402
from repro_torch.launch import bench_moe_ffn as tbm  # noqa: E402
from repro_torch.launch import bench_run as trun  # noqa: E402
from repro_torch.launch import bench_sched_overhead as tbo  # noqa: E402
from repro_torch.launch import bench_step as tbs  # noqa: E402
from repro_torch.launch import bench_topology as tbt  # noqa: E402


def _lines(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return buf.getvalue().splitlines(), out


def _row(name, us, derived=""):
    return f"{name},{us:.2f},{derived}"


def _ref_moe_ffn(ep):
    """``benchmarks/bench_moe_ffn.run``'s rows at one ep."""
    hw, rows, tot_b, tot_u = JA3(), [], 0.0, 0.0
    for direction, tag in (("forward", "fwd"), ("backward", "bwd")):
        s_base, s_opt = jc.compiled_pair(ep, direction)
        b, u = jbase(s_base, hw), juni(s_opt, hw)
        tot_b += b.makespan_us
        tot_u += u.makespan_us
        pb, pu = jbm.PAPER[(ep, tag)]
        rows += [
            _row(f"moe_ffn_ep{ep}_{tag}_baseline", b.makespan_us,
                 f"paper={pb}ms mac={b.mac_ratio:.2f}"),
            _row(f"moe_ffn_ep{ep}_{tag}_hyperparallel", u.makespan_us,
                 f"paper={pu}ms mac={u.mac_ratio:.2f} "
                 f"speedup={b.makespan_us / u.makespan_us:.2f}x "
                 f"paper_speedup={pb / pu:.2f}x"),
            _row(f"moe_ffn_ep{ep}_{tag}_d2c", u.dispatch_to_combine_us,
                 jc.phase_summary(u))]
    (fb, fu), (bb, bu) = jbm.PAPER[(ep, "fwd")], jbm.PAPER[(ep, "bwd")]
    rows.append(_row(f"moe_ffn_ep{ep}_total_speedup", 0.0,
                     f"{tot_b / tot_u:.2f}x (paper "
                     f"{(fb + bb) / (fu + bu):.2f}x)"))
    return rows


def _ref_step(ep):
    """``benchmarks/bench_step.run``'s rows at one ep."""
    hw, lam = JA3(), jbs.routing_imbalance(ep, 8)
    tot_b = tot_u = 0.0
    for direction in ("forward", "backward"):
        s_base, s_opt = jc.compiled_pair(ep, direction)
        tot_b += jbase(s_base, hw).makespan_us
        tot_u += juni(s_opt, hw).makespan_us
    step_base = tot_b * lam / jbs.MOE_FRACTION
    step_opt = step_base - tot_b * lam + tot_u * lam
    return [_row(f"train_step_ep{ep}_baseline", step_base,
                 f"lambda={lam:.2f}"),
            _row(f"train_step_ep{ep}_hyperparallel", step_opt,
                 f"e2e_speedup={step_base / step_opt:.3f}x "
                 f"paper={jbs.PAPER_E2E[ep]:.2f}x")]


def test_moe_ffn_rows_equal_the_reference_at_ep4(monkeypatch):
    monkeypatch.setattr(tbm, "EPS", (4,))
    got, rows = _lines(tbm.run)
    assert got == _ref_moe_ffn(4)
    assert [_row(*r) for r in rows] == got and len(got) == 7


def test_step_rows_equal_the_reference_at_ep4(monkeypatch):
    monkeypatch.setattr(tbs, "EPS", (4,))
    got, rows = _lines(tbs.run)
    assert got == _ref_step(4)
    assert [_row(*r) for r in rows] == got
    assert tbs.routing_imbalance(8, 8) == jbs.routing_imbalance(8, 8)


def test_sched_overhead_rows_equal_the_reference():
    want, _ = _lines(jbo.run)
    got, rows = _lines(tbo.run)
    assert got == want and len(rows) == len(tbo.SIZES) == 3


@pytest.mark.parametrize("case", range(6))
def test_imbalance_rows_equal_the_reference(monkeypatch, case):
    """One skew scenario a case (the reference's literal sweep, cut)."""
    ref_case = list(jbi._cases())[case]
    port_case = list(tbi._cases())[case]
    assert ref_case[0] == port_case[0]
    monkeypatch.setattr(jbi, "_cases", lambda: iter([ref_case]))
    monkeypatch.setattr(tbi, "_cases", lambda: iter([port_case]))
    want, _ = _lines(jbi.run)
    got, rows = _lines(tbi.run)
    assert got == want and len(rows) == 4


def test_topology_rows_equal_the_reference():
    want, _ = _lines(jbt.run)
    got, rows = _lines(tbt.run)
    assert got == want
    assert rows[-1] == ("topology_scenario_wins", 3.0, "required>=2of3")


def test_topology_gate_raises_as_the_reference(monkeypatch):
    for m in (jbt, tbt):
        monkeypatch.setattr(m, "WINS_REQUIRED", 4)
    msgs = []
    for m in (jbt, tbt):
        with pytest.raises(RuntimeError) as e:
            _lines(m.run)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "need >= 4" in msgs[0]


def _untimed(lines):
    """The lines with the host's times taken out: autoselect's µs column
    and its warm selection's µs."""
    out = []
    for ln in lines:
        ln = re.sub(r"warm(_worst)?=[0-9.]+(us|ms) ?", "", ln)
        out.append(re.sub(r"^(autoselect_[^,]+),[0-9.]+,", r"\1,T,", ln))
    return out


def _no_budgets(monkeypatch):
    """Both scripts' wall-clock budgets lifted: a loaded host must not
    decide a test (the gates' own test sets them to 0)."""
    for m in (jba, tba):
        monkeypatch.setattr(m, "COLD_BUDGET_MS", float("inf"))
        monkeypatch.setattr(m, "WARM_BUDGET_MS", float("inf"))


def test_autoselect_rows_equal_the_reference_but_for_the_times(monkeypatch):
    _no_budgets(monkeypatch)
    want, _ = _lines(jba.run)
    got, rows = _lines(tba.run)
    assert _untimed(got) == _untimed(want)
    assert len(rows) == 13 and rows[-1][0] == "autoselect_worst_cold"


@pytest.mark.parametrize("budget", ["COLD_BUDGET_MS", "WARM_BUDGET_MS"])
def test_autoselect_gates_raise_as_the_reference(monkeypatch, budget):
    """At a toy size, a budget of 0 ms fails both scripts alike."""
    for m in (jba, tba):
        for k, v in dict(EP=2, E_LOC=2, ROWS=16, M_SPLIT=4).items():
            monkeypatch.setattr(m, k, v)
        monkeypatch.setattr(m, budget, 0.0)
    msgs = []
    for m in (jba, tba):
        with pytest.raises(AssertionError) as e:
            _lines(m.run)
        msgs.append(re.sub(r"[0-9.]+ms", "T", str(e.value)))
    assert msgs[0] == msgs[1]


def test_bucket_policy_rows_equal_the_reference_but_for_the_times():
    want, _ = _lines(jbd.run)
    got, rows = _lines(tbd.run)
    assert [ln.split(",", 2)[::2] for ln in got] == \
        [ln.split(",", 2)[::2] for ln in want]
    assert len(rows) == 12 and rows[-1][0] == "dropless_hotspot_fitted"


def test_bucket_policy_gate_raises_as_the_reference(monkeypatch):
    """Every policy exact, on a short trace: bucketing cannot raise the hit
    rate, and both scripts refuse alike."""
    from repro.core.buckets import BucketSpec as JSpec
    from repro_torch.core.buckets import BucketSpec as TSpec
    for m, spec in ((jbd, JSpec), (tbd, TSpec)):
        monkeypatch.setattr(m, "STEPS", 4)
        monkeypatch.setattr(m, "_policies", lambda profile, spec=spec: {
            k: spec.exact() for k in ("exact", "linear16", "geometric8",
                                      "fitted")})
    msgs = []
    for m in (jbd, tbd):
        with pytest.raises(AssertionError) as e:
            _lines(m.run)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "must raise the cache hit rate" in msgs[0]


SECTIONS = "sched_overhead,topology,autoselect"


def test_runner_equals_the_reference_for_host_sections(monkeypatch):
    """Header, section titles and rows, autoselect's times excepted."""
    _no_budgets(monkeypatch)
    monkeypatch.setattr(sys, "argv", ["run.py", "--only", SECTIONS])
    want, _ = _lines(jrun.main)
    got, rc = _lines(trun.main, ["--only", SECTIONS, "--device", "cpu"])
    assert rc == 0 and got[0] == "name,us_per_call,derived"
    assert _untimed(got) == _untimed(want)
    assert [k for k, *_ in trun.SECTIONS] == [k for k, *_ in jrun.SECTIONS]


def test_runner_refuses_an_unknown_section_as_the_reference(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["run.py", "--only", "nope"])
    with pytest.raises(SystemExit) as want:
        jrun.main()
    with pytest.raises(SystemExit) as got:
        trun.main(["--only", "nope"])
    assert want.value.code == got.value.code == 2


def test_runner_reports_a_failed_section(monkeypatch):
    """A section that raises prints ``<key>_FAILED`` and the exit code is
    1; the run goes on to the next section."""
    monkeypatch.setattr(tbt, "WINS_REQUIRED", 4)
    lines, rc = _lines(trun.main, ["--only", "topology,sched_overhead",
                                   "--device", "cpu"])
    assert rc == 1 and lines[-1].startswith("topology_FAILED,0,")
    assert any(ln.startswith("sched_overhead_M32768_dynamic,")
               for ln in lines)
