"""The port's four examples (``repro_torch.examples``) on the CPU at their
smoke sizes, and their schedule numbers against the reference's, computed
in process through ``repro.core`` (the reference's example scripts are not
run): tasks, events, queue lengths, event thresholds, simulated µs, the
SSC cache's hits and misses on the port's router output, and
``rank_view``.
"""

import collections
import json
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmarks.common import paper_module_config  # noqa: E402
from repro.core import odg as JO  # noqa: E402
from repro.core.scheduler import compile_schedule as jcompile  # noqa: E402
from repro.core.simulator import simulate_baseline as jbase  # noqa: E402
from repro.core.simulator import simulate_unified as juni  # noqa: E402
from repro.core.ssc import SSCCache as JCache  # noqa: E402
from repro.core.ssc import rank_view as jrank_view  # noqa: E402
from repro.models.moe import MoEConfig as JMoEConfig  # noqa: E402
from repro.models.moe import plan_from_routing as jplan  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.examples import schedule_explorer  # noqa: E402
from repro_torch.examples import serve_decode  # noqa: E402
from repro_torch.examples import train_moe_e2e  # noqa: E402


@pytest.fixture(scope="module")
def quick():
    return quickstart.main(["--device", "cpu", "--steps", "3"])


def test_quickstart_schedule_numbers_equal_the_reference(quick):
    cfg = JO.ScheduleConfig(**quickstart.SCHED,
                            gmm_m_split=quickstart.M_SPLIT)
    s = jcompile(JO.build_moe_ffn_forward(cfg), pipeline=["ratr"])
    assert (quick["tasks"], quick["events"], quick["ctq0"],
            quick["vtq0"]) == (s.n_tasks, len(s.events),
                               len(s.queue(0, "CTQ")),
                               len(s.queue(0, "VTQ")))
    base = jbase(jcompile(JO.build_moe_ffn_forward(
        JO.ScheduleConfig(**quickstart.SCHED))))
    assert quick["base_us"] == base.makespan_us
    assert quick["unified_us"] == juni(s).makespan_us
    assert quick["executor_max_abs_err"] <= 1e-5


def test_quickstart_cache_equals_the_reference_on_its_routing(quick):
    """The reference's bucketed plans (``bucket_rows=32``) of the same
    router output, through the reference's cache."""
    tmc = quickstart.DROPLESS_MC
    mc = JMoEConfig(n_experts=tmc.n_experts, top_k=tmc.top_k,
                    d_expert=tmc.d_expert)
    ep = quickstart.DROPLESS_EP
    cache = JCache(max_entries=16)
    for top_i in quick["top_i"]:
        bridge = jplan(np.asarray(top_i), mc, ep, capacity=None,
                       bucket_rows=32)
        cfg = JO.ScheduleConfig(ep=ep, e_loc=mc.n_experts // ep, rows=0,
                                d_model=quickstart.DROPLESS_D,
                                d_ff=mc.d_expert, plan=bridge.plan)
        cache.get_or_compile(cfg, "forward", pipeline=["ratr"])
    want = cache.info()
    got = quick["cache"]
    assert {k: got[k] for k in ("entries", "hits", "misses")} == \
        {k: want[k] for k in ("entries", "hits", "misses")}


def test_quickstart_trains(quick):
    assert len(quick["losses"]) == 3
    assert all(np.isfinite(quick["losses"]))


def test_schedule_explorer_equals_the_reference(tmp_path):
    dump = tmp_path / "rank0.json"
    out = schedule_explorer.main(["--ep", "4", "--dump", str(dump),
                                  "--device", "cpu"])
    cfg = paper_module_config(4, m_split_mult=4)
    scheds = {}
    for name, build, pipe in (
            ("forward", JO.build_moe_ffn_forward, ["ratr"]),
            ("backward", JO.build_moe_ffn_backward,
             ["ratr", "gmm_interleave"])):
        s = scheds[name] = jcompile(build(cfg), pipeline=pipe)
        b = jbase(jcompile(build(paper_module_config(4, m_split_mult=1))))
        u = juni(s)
        got = dict(out["schedules"][name])
        # The port's SSC blobs are JSON, the reference's msgpack: their
        # sizes differ by design.
        assert got.pop("ssc_bytes") > 0
        assert got == {
            "tasks": s.n_tasks, "events": len(s.events),
            "ctq0": len(s.queue(0, "CTQ")), "vtq0": len(s.queue(0, "VTQ")),
            "thresholds": dict(sorted(collections.Counter(
                e.threshold for e in s.events.values()).items())),
            "base_us": b.makespan_us, "unified_us": u.makespan_us,
            "base_mac": b.mac_ratio, "unified_mac": u.mac_ratio}, name
    want = json.loads(json.dumps(jrank_view(scheds["forward"], 0)))
    assert json.loads(dump.read_text()) == want
    assert out["dump"] == str(dump)


def test_schedule_explorer_dumps_to_a_new_temporary_file(tmp_path,
                                                         monkeypatch):
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    out = schedule_explorer.main(["--ep", "2", "--device", "cpu"])
    path = pathlib.Path(out["dump"])
    assert path.parent == tmp_path and json.loads(path.read_text())


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-3b-a800m"])
def test_serve_decode_runs(arch):
    out = serve_decode.main(["--arch", arch, "--batch", "2",
                             "--prompt-len", "8", "--gen", "4",
                             "--device", "cpu"])
    assert tuple(out["tokens"].shape) == (2, 4)


def test_train_moe_e2e_trains_checkpoints_and_resumes(tmp_path):
    argv = ["--seq", "16", "--batch", "2", "--log-every", "1",
            "--ckpt-every", "2", "--ckpt-dir", str(tmp_path), "--device",
            "cpu"]
    run = train_moe_e2e.main(["--steps", "2", *argv])
    assert run.resumed_from is None and run.step == 2
    assert all(np.isfinite(m["loss"]) for m in run.metrics_log)
    again = train_moe_e2e.main(["--steps", "3", *argv])
    assert again.resumed_from == 2 and again.step == 3
    assert [m["step"] for m in again.metrics_log] == [1, 2, 3]


@pytest.mark.parametrize("example, argv", [
    (quickstart, []), (schedule_explorer, ["--ep", "2"]),
    (serve_decode, []), (train_moe_e2e, ["--steps", "1"])])
def test_examples_default_to_the_card(monkeypatch, example, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main(argv)
