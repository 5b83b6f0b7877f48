"""The port's schedule-pipeline sweep (``repro_torch.launch.schedsweep``)
against the JAX package's (``repro.launch.schedsweep``), on the CPU: the
fixture-sized sweep of ``tests/test_autoselect.py`` and the selector's
accuracy table, row for row. Their makespans are the simulator's
predictions for an Ascend A3, not measurements."""

import json

import pytest

pytest.importorskip("torch")

from repro.launch import schedsweep as jsw  # noqa: E402
from repro_torch.launch import schedsweep as tsw  # noqa: E402

FIXTURE_SWEEP = dict(ep=8, e_loc=2, rows=256, d_model=1024, d_ff=512,
                     gmm_m_split=64)


@pytest.fixture(scope="module")
def sweeps():
    return {n: (m.sched_sweep(quiet=True, **FIXTURE_SWEEP),
                m.selector_report(quiet=True, **FIXTURE_SWEEP))
            for n, m in (("jax", jsw), ("port", tsw))}


def test_sched_sweep_rows_equal_jax(sweeps):
    assert sweeps["port"][0] == sweeps["jax"][0]
    assert {r["pipeline"] for r in sweeps["port"][0]} >= {"auto", "naive"}


def test_selector_report_rows_equal_jax(sweeps):
    assert sweeps["port"][1] == sweeps["jax"][1]
    assert sum(r["picked"] for r in sweeps["port"][1]) == 8


def test_scenarios_equal_jax():
    for ep, e_loc, rows in ((8, 2, 256), (4, 3, 16), (2, 1, 4)):
        a = [(n, None if p is None else p.counts)
             for n, p in tsw.sweep_scenarios(ep, e_loc, rows)]
        b = [(n, None if p is None else p.counts)
             for n, p in jsw.sweep_scenarios(ep, e_loc, rows)]
        assert a == b


def test_main_writes_the_tables(tmp_path, capsys):
    """The command line writes the sweep (JSON) and the report (JSONL)."""
    small = ["--ep", "1"]
    tsw.main(["--sched-sweep", *small, "--out", str(tmp_path / "s.json")])
    rows = json.loads((tmp_path / "s.json").read_text())
    assert rows == jsw.sched_sweep(ep=1, quiet=True)
    tsw.main(["--selector-report", *small,
              "--report-out", str(tmp_path / "r.jsonl")])
    lines = (tmp_path / "r.jsonl").read_text().splitlines()
    assert [json.loads(x) for x in lines] == \
        jsw.selector_report(ep=1, quiet=True)
    assert "[selector" in capsys.readouterr().out
    for bad in ([], ["--report-out", "x.jsonl"]):
        with pytest.raises(SystemExit):
            tsw.main(bad)
