"""The port's host-only benchmark twins (``repro_torch.launch.bench_fusion``
and ``bench_elastic``) against the reference's scripts
(``benchmarks/bench_fusion.py``, ``bench_elastic.py``), on the CPU.

``bench_fusion``'s rows are the simulator's makespans on the Ascend A3
model, so they must equal the reference's line for line. ``bench_elastic``
times host code: its rows must equal the reference's but for the times,
and no test here holds a time to a budget (the scripts do).
"""

import contextlib
import io
import pathlib
import sys

import pytest

pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmarks import bench_elastic as jbe  # noqa: E402
from benchmarks import bench_fusion as jbf  # noqa: E402
from repro_torch.launch import bench_elastic as tbe  # noqa: E402
from repro_torch.launch import bench_fusion as tbf  # noqa: E402


def _lines(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return buf.getvalue().splitlines(), out


def test_bench_fusion_rows_equal_jax(monkeypatch):
    """Both sections at the scripts' own shapes; the PP section at S = 2
    only (S = 4 doubles the run and changes nothing the rows compare)."""
    for m in (jbf, tbf):
        monkeypatch.setattr(m, "PP_STAGES", (2,))
    want, _ = _lines(jbf.run)
    got, rows = _lines(tbf.run)
    assert got == want
    assert len(rows) == len(got) == 20
    wins = {name: us for name, us, _ in rows if name.endswith("_wins")}
    assert wins == {"fusion_scenario_wins": 3.0, "pp2_scenario_wins": 3.0}


def test_bench_fusion_gate_raises_as_jax(monkeypatch):
    """At a toy size with an unreachable gate, both scripts refuse alike."""
    for m in (jbf, tbf):
        for k, v in dict(EP=2, E_LOC=2, ROWS=16, M_SPLIT=4,
                         WINS_REQUIRED=4).items():
            monkeypatch.setattr(m, k, v)
    msgs = []
    for m in (jbf, tbf):
        with pytest.raises(RuntimeError) as e:
            _lines(m.run)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "need >= 4" in msgs[0]


def _untimed(lines):
    return [(ln.split(",", 2)[0], ln.split(",", 2)[2]) for ln in lines]


def test_bench_elastic_rows_equal_jax_but_for_the_times(monkeypatch):
    want, _ = _lines(jbe.run)
    got, rows = _lines(tbe.run)
    assert _untimed(got) == _untimed(want)
    assert [r[0] for r in rows] == [
        "elastic_remap_plan", "elastic_check_remap",
        "elastic_rekey_for_mesh", "elastic_biased_select"]
    assert rows[-1][2] == "pick=ratr+crit crit_pass=True"
    monkeypatch.setattr(tbe, "REMAP_BUDGET_MS", 0.0)
    with pytest.raises(RuntimeError, match="budget 0.0 ms"):
        _lines(tbe.run)
