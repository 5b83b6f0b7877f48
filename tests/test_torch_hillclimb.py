"""The port's hill-climb loop (``repro_torch.launch.hillclimb``) against
the reference's (``src/repro/launch/hillclimb.py``), on the CPU.

The reference module is read with ``ast``, never imported: its first lines
set ``XLA_FLAGS`` to 512 host devices, which would reach every later JAX
test of the same worker. Its cells, its variant if-chain and
``compile_variant``'s defaults are the table the port's must equal. The
counts run a smoke config's real step on the meta device over four
virtual ranks, and are held to a CPU run of the same step. On the
reference's 16x16 mesh (the CLI's default) the cells' variants count rank
0 of the counting mesh: llama's decode without flash decoding moves its
cache, and granite's training variants all count.
"""

import ast
import contextlib
import dataclasses
import inspect
import io
import json
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticStream  # noqa
from repro_torch.launch import hillclimb as H  # noqa: E402
from repro_torch.launch import schedsweep  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.train import pad_experts  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

REF = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro"
       / "launch" / "hillclimb.py")
SHAPE = ShapeSpec("train_smoke", 32, 2, "train")
EP = 4


def _literal_kw(call) -> dict:
    out = {}
    for k in call.keywords:
        try:
            out[k.arg] = ast.literal_eval(k.value)
        except ValueError:
            out[k.arg] = None          # a name: resolved by the arch
    return out


def _branch(body) -> dict:
    """What one ``if v == ...`` branch of the reference passes: its tag,
    config fields, compile keywords, and whether it patches flash decoding
    away."""
    tag, fields, kw, fd_off = None, {}, None, False
    for node in (n for b in body for n in ast.walk(b)):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            if node.func.id == "measure":
                arg = node.args[2]
                tag = arg.value if isinstance(arg, ast.Constant) else None
                kw = _literal_kw(node)
            elif node.func.id == "compile_variant" and kw is None:
                kw = {k: v for k, v in _literal_kw(node).items()
                      if k != "policy_cfg"}
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "replace"):
            fields = _literal_kw(node)
        elif isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value == "tag":
                    tag = ast.literal_eval(v)
        elif (isinstance(node, ast.Assign)
              and isinstance(node.targets[0], ast.Attribute)
              and node.targets[0].attr == "make_flash_decode"):
            fd_off = True
    return {"tag": tag, "fields": fields, "kw": kw or {}, "fd_off": fd_off}


@pytest.fixture(scope="module")
def reference():
    tree = ast.parse(REF.read_text())
    out = {"variants": {}}
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "CELLS"):
            out["cells"] = ast.literal_eval(node.value)
        elif isinstance(node, ast.FunctionDef):
            if node.name == "compile_variant":
                out["defaults"] = {
                    a.arg: ast.literal_eval(d) for a, d in zip(
                        node.args.kwonlyargs, node.args.kw_defaults)
                    if d is not None and a.arg in (
                        "mode", "ep_mode", "seq_parallel", "cap_factor")}
            elif node.name == "main":
                for n in ast.walk(node):
                    if (isinstance(n, ast.If)
                            and isinstance(n.test, ast.Compare)
                            and getattr(n.test.left, "id", None) == "v"):
                        out["variants"][n.test.comparators[0].value] = \
                            _branch(n.body)
    return out


def test_cells_and_variant_names_equal_the_reference(reference):
    assert H.CELLS == reference["cells"]
    assert list(H.VARIANTS) == list(reference["variants"])


def test_variant_table_equals_the_reference(reference):
    """Each variant's tag, config fields and compile keywords, with the
    reference's ``compile_variant`` defaults filled in; ``flashdecode_off``
    is the reference's patch of ``make_flash_decode``."""
    defaults = reference["defaults"]
    sig = inspect.signature(H.step_kwargs).parameters
    assert {k: sig[k].default for k in defaults} == defaults
    for name, ref in reference["variants"].items():
        if name == "opt":
            continue
        tag, fields, kw = H.VARIANTS[name]
        assert tag == ref["tag"], name
        assert fields == ref["fields"], name
        port = {**defaults, **kw}
        assert port.pop("flash_decode", True) is not ref["fd_off"], name
        assert port == {**defaults, **ref["kw"]}, name


def test_opt_resolves_as_the_reference():
    for arch, _ in H.CELLS.values():
        mode = "ep_dp" if "moe" in arch or "granite" in arch else "zero1"
        assert H.resolve_variant(arch, "opt") == (f"opt({mode})", {},
                                                  {"mode": mode})
    with pytest.raises(ValueError, match="unknown variant"):
        H.resolve_variant("llama3.2-3b", "turbo")


def _cfg():
    return pad_experts(dataclasses.replace(
        get_smoke_config("granite-moe-3b-a800m"), remat=True), EP)


@pytest.fixture(scope="module")
def counts():
    cfg, out = _cfg(), {}
    for v in ("baseline", "zero1", "nosp", "zero1_noremat", "ep_dp",
              "ep_dp_baselinea2a"):
        out[v] = H.count_variant(cfg, SHAPE, make_mesh((1, EP), "meta"),
                                 v)[1]
    return out


def _work(rf):
    return (rf.flops_per_device, rf.bytes_per_device, rf.collective_bytes,
            rf.coll_counts)


def test_placement_variants_count_the_same_work(counts):
    assert _work(counts["baseline"]) == _work(counts["zero1"]) \
        == _work(counts["nosp"])
    assert counts["baseline"].mesh == "1x4"


def test_noremat_counts_fewer_flops(counts):
    assert counts["zero1_noremat"].flops_per_device \
        < counts["baseline"].flops_per_device


def test_ring_and_all_to_all_move_the_same_bytes(counts):
    ring, a2a = counts["ep_dp"], counts["ep_dp_baselinea2a"]
    assert set(ring.coll_counts) == {"collective-permute"}
    assert set(a2a.coll_counts) == {"all-to-all"}
    assert ring.collective_bytes == a2a.collective_bytes > 0
    assert ring.t_collective > 0


@pytest.mark.parametrize("variant", ["ep_dp", "ep_dp_baselinea2a"])
def test_counted_collectives_equal_a_cpu_run(counts, variant):
    """The same variant's step on the CPU, through ``variant_steps``, sends
    what the meta count says."""
    mesh = make_mesh((1, EP), "cpu")
    vcfg, fns = H.variant_steps(_cfg(), mesh, variant)
    params = adamw.cast_params(M.init_params(
        vcfg, torch.Generator().manual_seed(0), device="cpu"),
        vcfg.compute_dtype)
    batch = SyntheticStream(DataConfig(
        vocab=vcfg.vocab, seq_len=SHAPE.seq_len,
        global_batch=SHAPE.global_batch)).batch(0, "cpu")
    mesh.comm.stats.reset()
    _, _, m = fns.train_step(params, adamw.init_opt_state(params), batch)
    assert torch.isfinite(m["loss"])
    rf = counts[variant]
    assert dict(mesh.comm.stats.counts) == rf.coll_counts
    assert mesh.comm.stats.bytes == rf.collective_bytes


LINE = re.compile(
    r"^\[(?P<tag>[^\]]+)\] compute= *[0-9.]+ms memory= *[0-9.]+ms "
    r"collective= *(?P<coll>[0-9.]+)ms → (compute|memory|collective)-bound "
    r"frac=[0-9.]+ \(args=[0-9.]+G temp=[0-9.]+G\)$")


def test_printed_line_and_out_json(tmp_path, monkeypatch):
    """``main`` on a smoke cell: one line a variant in the reference's
    format, and ``--out``'s rows with ``Roofline.row()``'s keys plus tag,
    args_gb and temp_gb."""
    monkeypatch.setitem(H.CELLS, "granite_train",
                        ("granite-moe-3b-a800m", SHAPE))
    monkeypatch.setattr(H, "get_config", lambda arch: _cfg())
    out = tmp_path / "rows.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        H.main(["--cell", "granite_train", "--variants",
                "baseline,ep_dp_baselinea2a", "--mesh", "1x4",
                "--out", str(out)])
    lines = [ln for ln in buf.getvalue().splitlines()
             if not ln.startswith("#")]
    m = [LINE.match(ln) for ln in lines]
    assert all(m), lines
    assert [x["tag"] for x in m] == ["baseline(tp_sp)", "ep_dp+a2a"]
    assert float(m[1]["coll"]) >= 0.0
    rows = json.loads(out.read_text())
    keys = set(H.count_variant(_cfg(), SHAPE, make_mesh((1, EP), "meta"))[1]
               .row())
    for r in rows:
        assert keys | {"tag", "args_gb", "temp_gb"} <= set(r)
    assert rows[1]["collectives"] == {"all-to-all": rows[1]["collectives"][
        "all-to-all"]}


def _main_rows(monkeypatch, tmp_path, argv, n_layers=2):
    """``main(argv)``'s JSON rows, each cell's arch cut to ``n_layers``."""
    from repro_torch.configs import get_config
    monkeypatch.setattr(H, "get_config", lambda arch: dataclasses.replace(
        get_config(arch), n_layers=n_layers))
    out = tmp_path / "rows.json"
    with contextlib.redirect_stdout(io.StringIO()):
        H.main(argv + ["--out", str(out)])
    return json.loads(out.read_text())


def test_decode_without_flash_decoding_moves_the_cache(monkeypatch,
                                                       tmp_path):
    """``--cell llama_decode`` on the default 16x16 (rank 0 of the counting
    mesh, 256 chips): ``flashdecode_off`` gathers each layer's cache blocks
    over ``model``, so it counts more collective bytes and more bytes a
    device than ``baseline``, whose flash decoding combines statistics."""
    base, off = _main_rows(monkeypatch, tmp_path, [
        "--cell", "llama_decode", "--variants", "baseline,flashdecode_off"])
    assert [r["tag"] for r in (base, off)] == ["baseline(tp_sp)",
                                               "decode_dense_gspmd"]
    assert base["mesh"] == off["mesh"] == "16x16"
    assert base["chips"] == 256
    assert off["collective_bytes_per_dev"] > 5 * base[
        "collective_bytes_per_dev"] > 0
    assert off["bytes_per_dev"] > base["bytes_per_dev"]


def test_granite_train_variants_count_on_the_production_mesh(monkeypatch,
                                                             tmp_path):
    """Every variant of ``granite_train`` counts on 16x16 with no failure,
    each in its mode: EP moves tokens in each, ep_dp's baseline
    all-to-all where its ring permutes."""
    variants = ["baseline", "zero1", "zero1_noremat", "ep_dp",
                "ep_dp_savemoe", "ep_dp_baselinea2a", "nosp", "opt"]
    rows = _main_rows(monkeypatch, tmp_path, [
        "--cell", "granite_train", "--variants", ",".join(variants),
        "--mesh", "16x16"])
    assert [r["variant"] for r in rows] == variants
    for r in rows:
        assert r["chips"] == 256 and r["flops_per_dev"] > 0
        assert r["collective_bytes_per_dev"] > 0
    by = {r["variant"]: r for r in rows}
    assert "all-to-all" in by["ep_dp_baselinea2a"]["collectives"]
    assert "collective-permute" in by["ep_dp"]["collectives"]
    assert by["zero1_noremat"]["flops_per_dev"] < by["zero1"][
        "flops_per_dev"]


def test_unknown_variant_is_an_error():
    with pytest.raises(SystemExit) as e:
        H.main(["--cell", "llama_decode", "--variants", "baseline,turbo"])
    assert e.value.code == 2


@pytest.mark.parametrize("argv, want", [
    (["--sched-sweep", "--ep", "2"], ["--ep", "2", "--sched-sweep"]),
    (["--selector-report", "--report-out", "r.jsonl"],
     ["--ep", "8", "--selector-report", "--report-out", "r.jsonl"]),
    (["--sched-sweep", "--out", "o.json"],
     ["--ep", "8", "--sched-sweep", "--out", "o.json"])])
def test_sweep_flags_hand_off_as_the_reference(monkeypatch, argv, want):
    seen = []
    monkeypatch.setattr(schedsweep, "main", seen.append)
    H.main(argv)
    assert seen == [want]


def test_sched_sweep_output_equals_schedsweep():
    outs = []
    for fn, argv in ((H.main, ["--sched-sweep", "--ep", "2"]),
                     (schedsweep.main, ["--sched-sweep", "--ep", "2"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn(argv)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "[sched" in outs[0]
