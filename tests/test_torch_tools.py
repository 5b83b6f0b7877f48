"""The port's ``tools.selector_error`` against the reference's
``tools/selector_error.py``, and ``parallel.ctx``'s ambient overrides, on
the CPU.

``selector_error`` must give the reference tool's metrics dict on the same
JSONL (the reference test's synthetic rows and a small selector report of
the port), and the same gates and exit codes. ``ctx``: a forward under
``moe_impl_context(impl)`` equals ``forward(moe_impl=impl)`` bit for bit, a
decode under ``flash_decode_context`` reaches the ambient impl (the dense
path where it returns ``None``), and an explicit argument wins.
"""

import dataclasses
import importlib.util
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.launch.schedsweep import selector_report  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.parallel import ctx  # noqa: E402
from repro_torch.parallel.flash_decode import make_flash_decode  # noqa
from repro_torch.tools import selector_error as tse  # noqa: E402

_TOOL = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
    "selector_error.py"
_spec = importlib.util.spec_from_file_location("_ref_selector_error", _TOOL)
jse = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jse)


def _row(plan, cand, pred, sim, picked, sim_best, regret=None):
    return {"plan": plan, "direction": "forward", "candidate": cand,
            "predicted_us": pred, "simulated_us": sim, "picked": picked,
            "sim_best": sim_best, "regret": regret,
            "ep": 4, "e_loc": 8, "rows": 32, "d_model": 64, "d_ff": 32,
            "gmm_m_split": 8}


SYNTHETIC = [
    _row("a", "x", 10.0, 12.0, True, True, 0.0),
    _row("a", "y", 20.0, 24.0, False, False),
    _row("b", "x", 10.0, 21.0, True, False, 0.05),
    _row("b", "y", 20.0, 20.0, False, True),
]


def _write(tmp_path, rows, name="r.jsonl"):
    p = tmp_path / name
    p.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return str(p)


@pytest.fixture(scope="module")
def port_report(tmp_path_factory):
    out = tmp_path_factory.mktemp("report") / "report.jsonl"
    rows = selector_report(ep=2, e_loc=4, rows=16, d_model=64, d_ff=32,
                           report_out=str(out), quiet=True)
    assert rows
    return str(out)


def test_metrics_equal_the_reference_on_synthetic_rows(tmp_path):
    path = _write(tmp_path, SYNTHETIC)
    got = tse.aggregate(tse.load_rows([path]))
    assert got == jse.aggregate(jse.load_rows([path]))
    assert got["argmin_match_rate"] == pytest.approx(0.5)
    assert got["pairwise_ordering_accuracy"] == pytest.approx(0.5)


def test_metrics_equal_the_reference_on_a_port_report(port_report):
    got = tse.aggregate(tse.load_rows([port_report]))
    assert got == jse.aggregate(jse.load_rows([port_report]))
    assert got["scenarios"] > 0 and got["mean_regret"] >= 0.0


@pytest.mark.parametrize("gates, code", [
    ([], 0), (["--min-argmin-rate", "0.5", "--max-mean-regret", "0.1"], 0),
    (["--min-argmin-rate", "0.9"], 1), (["--max-mean-regret", "0.01"], 1),
    (["--min-argmin-rate", "1.5", "--max-mean-regret", "0.0"], 1)])
def test_gates_and_exit_codes_equal_the_reference(tmp_path, capsys, gates,
                                                  code):
    path = _write(tmp_path, SYNTHETIC)
    outs = []
    for tool in (jse, tse):
        js = str(tmp_path / f"{tool.__name__}.json")
        assert tool.main([path, "--json", js, *gates]) == code
        cap = capsys.readouterr()
        outs.append((cap.out, cap.err, json.loads(
            pathlib.Path(js).read_text())))
    assert outs[0] == outs[1]


def test_bad_inputs_raise_as_the_reference(tmp_path):
    bad = tmp_path / "bad.jsonl"
    bad.write_text("{not json\n")
    for tool in (jse, tse):
        with pytest.raises(FileNotFoundError):
            tool.load_rows([str(tmp_path / "missing.jsonl")])
        with pytest.raises(ValueError, match="bad JSONL"):
            tool.load_rows([str(bad)])


# --- parallel.ctx ------------------------------------------------------------

# fp32, so that flash decoding's combine differs from the dense path by
# fp32 rounding only.
CFG = dataclasses.replace(get_smoke_config("granite-moe-3b-a800m"),
                          dtype="float32")


@pytest.fixture(scope="module")
def params():
    return M.init_params(CFG, torch.Generator().manual_seed(0), device="cpu")


def _tokens(B=2, S=8, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, CFG.vocab, (B, S), generator=g)


def _scaled(scale):
    """A MoE impl that differs from the default: its output times
    ``scale``."""
    base = M.default_moe_impl(CFG)

    def impl(p, h, mc):
        return scale * base(p, h, mc)
    return impl


def test_forward_under_moe_context_equals_explicit_impl(params):
    batch = {"tokens": _tokens()}
    impl = _scaled(0.5)
    want = M.forward(CFG, params, batch, moe_impl=impl)
    with ctx.moe_impl_context(impl):
        got = M.forward(CFG, params, batch)
        loss = M.loss_fn(CFG, params, dict(batch, labels=batch["tokens"]))
    assert torch.equal(got, want)
    assert not torch.equal(M.forward(CFG, params, batch), want)
    assert torch.equal(loss, M.loss_fn(CFG, params, dict(
        batch, labels=batch["tokens"]), moe_impl=impl))
    assert ctx.current_moe_impl() is None


def test_explicit_moe_impl_wins_over_the_context(params):
    batch = {"tokens": _tokens()}
    other = _scaled(2.0)
    want = M.forward(CFG, params, batch, moe_impl=other)
    with ctx.moe_impl_context(_scaled(0.5)):
        assert torch.equal(M.forward(CFG, params, batch, moe_impl=other),
                           want)


def _decode(params, **kw):
    """Prefill 8 tokens into a 16-slot cache, then one decode step."""
    with torch.no_grad():
        last, cache = M.prefill(CFG, params, {"tokens": _tokens()}, 16)
        tok = torch.argmax(last, -1)[:, None]
        return M.decode_step(CFG, params, tok, cache, **kw)[0]


def _recording(seen, impl=None):
    def fd(*a, **k):
        seen.append(1)
        return None if impl is None else impl(*a, **k)
    return fd


def test_decode_under_a_declining_context_takes_the_dense_path(params):
    want, seen = _decode(params), []
    with ctx.flash_decode_context(_recording(seen)):
        got = _decode(params)
    assert seen and len(seen) == CFG.n_layers
    assert torch.equal(got, want)
    assert ctx.current_flash_decode() is None


def test_decode_under_a_flash_context_runs_it(params):
    """The ambient impl runs (its pmax and psums count), within fp32
    rounding of the dense path; an explicit impl wins over it."""
    mesh = make_test_mesh(1, 4, device="cpu")
    dense, seen, explicit = _decode(params), [], []
    with ctx.flash_decode_context(_recording(seen, make_flash_decode(mesh))):
        got = _decode(params)
        combines = dict(mesh.comm.stats.counts)
        mesh.comm.stats.reset()
        won = _decode(params, flash_decode=_recording(explicit))
    assert len(seen) == CFG.n_layers and len(explicit) == CFG.n_layers
    assert combines == {"all-reduce": 3 * CFG.n_layers}
    assert torch.allclose(got, dense, rtol=1e-4, atol=1e-4)
    assert torch.equal(won, dense) and mesh.comm.stats.bytes == 0


def test_nested_contexts_restore_and_constraints_place_nothing():
    a, b = object(), object()
    with ctx.moe_impl_context(a):
        with ctx.moe_impl_context(b):
            assert ctx.current_moe_impl() is b
        assert ctx.current_moe_impl() is a
    assert ctx.current_moe_impl() is None
    x = torch.ones(2, 3, 4, 5)
    with ctx.activation_sharding(("data", None, None)), \
            ctx.head_sharding(("data", None, "model", None)):
        assert ctx.constrain_activation(x) is x
        assert ctx.constrain_heads(x) is x


def test_flash_decode_context_is_per_thread(params):
    import threading
    seen = []
    with ctx.flash_decode_context(_recording(seen)):
        out = {}
        t = threading.Thread(target=lambda: out.setdefault(
            "fd", ctx.current_flash_decode()))
        t.start()
        t.join()
    assert out["fd"] is None
