"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points refuse to run on the CPU unless asked to."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
sys.argv = ["chip_smoke.py"]
import chip_smoke  # module import only; main() is not run
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 102          # every package and module was imported


_ALONE = r"""
import importlib, sys
importlib.import_module(sys.argv[1])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack",
                                    "ml_dtypes"))
assert not bad, bad
"""


@pytest.mark.parametrize("module", [
    "repro_torch.core.fusion", "repro_torch.core.elastic",
    "repro_torch.launch.schedsweep", "repro_torch.launch.dropless",
    "repro_torch.launch.bench_fused_dropless",
    "repro_torch.launch.bench_fusion", "repro_torch.launch.bench_elastic",
    "repro_torch.parallel.ep", "repro_torch.launch.replay",
    "repro_torch.launch.online", "repro_torch.launch.bench_replay",
    "repro_torch.launch.serve", "repro_torch.launch.profile_serve",
    "repro_torch.parallel.comm", "repro_torch.parallel.flash_decode",
    "repro_torch.launch.mesh", "repro_torch.launch.bench_ep_modes",
    "repro_torch.configs.deepseek_moe_paper",
    "repro_torch.checkpoint.ckpt", "repro_torch.ft.runner",
    "repro_torch.ft.harness", "repro_torch.launch.train",
    "repro_torch.models.ssm", "repro_torch.models.rglru",
    "repro_torch.configs.llama3_2_3b", "repro_torch.configs.qwen2_1_5b",
    "repro_torch.configs.olmo_1b", "repro_torch.configs.gemma_2b",
    "repro_torch.configs.dbrx_132b", "repro_torch.configs.mamba2_1_3b",
    "repro_torch.configs.recurrentgemma_2b",
    "repro_torch.configs.hubert_xlarge", "repro_torch.configs.internvl2_26b",
    "repro_torch.configs.shapes", "repro_torch.parallel.roofline",
    "repro_torch.launch.dryrun", "repro_torch.launch.bench_roofline",
    "repro_torch.kernels.work", "repro_torch.parallel.ctx",
    "repro_torch.launch.bench_common", "repro_torch.launch.hillclimb",
    "repro_torch.launch.bench_moe_ffn", "repro_torch.launch.bench_step",
    "repro_torch.launch.bench_autoselect",
    "repro_torch.launch.bench_imbalance",
    "repro_torch.launch.bench_sched_overhead",
    "repro_torch.launch.bench_topology", "repro_torch.launch.bench_run",
    "repro_torch.launch.bench_dropless_buckets",
    "repro_torch.tools.selector_error", "repro_torch.examples.quickstart",
    "repro_torch.examples.schedule_explorer",
    "repro_torch.examples.serve_decode",
    "repro_torch.examples.train_moe_e2e", "repro_torch.parallel.tp"])
def test_fusion_and_elastic_modules_import_alone(module):
    """Each module of the fusion/elastic slice, of the online serving
    slice, of EP, of checkpointing, of the model families, of the shapes,
    roofline and dry run, of the one-card tools (hill-climb, the
    benchmark twins and runner, selector_error, ctx, the examples) and of
    tensor parallelism across processes (tp),
    imported on its own in a fresh interpreter, pulls in neither JAX, the
    JAX package, msgpack nor ml_dtypes."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _ALONE, module],
                          cwd=str(REPO), env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert (REPO / "src" / (module.replace(".", "/") + ".py")).is_file()


FORBIDDEN = ("jax", "jaxlib", "repro", "triton", "msgpack", "ml_dtypes")


def _imported_roots(tree):
    """(line, top-level package) of every import anywhere in ``tree``:
    module level or inside a function, ``import`` and ``from`` forms, and
    ``importlib.import_module``/``__import__`` of a constant name."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and ((isinstance(node.func, ast.Attribute)
                    and node.func.attr == "import_module")
                   or (isinstance(node.func, ast.Name)
                       and node.func.id == "__import__"))):
            yield node.lineno, node.args[0].value.split(".")[0]


def test_no_forbidden_import_anywhere_in_the_source():
    """A static check of what the subprocess probe cannot see: imports in
    function bodies that an import alone never runs. Nothing of the port
    or ``chip_smoke.py`` may import JAX, the JAX package, Triton (absent
    where the CPU tests run), msgpack or ml_dtypes (absent on the card's
    machine)."""
    files = _port_files()
    bad = [f"{f.relative_to(REPO)}:{line}: {root}"
           for f in files
           for line, root in _imported_roots(ast.parse(f.read_text()))
           if root in FORBIDDEN]
    assert len(files) >= 30
    assert not bad, bad


def _port_files() -> list:
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    return files


def _tmp_paths(tree):
    """(line, string) of every string constant that names a path under
    ``/tmp``."""
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and node.value.startswith("/tmp")):
            yield node.lineno, node.value


def test_no_fixed_path_under_tmp():
    """No module of the port and not ``chip_smoke.py`` holds a path under
    ``/tmp`` (as a default or otherwise): a fixed directory is shared by
    every run on the machine, and the reference's default checkpoint
    directory makes each run resume from the one before it. Checkpoints and
    scratch go where the caller says, or under ``tempfile``."""
    bad = [f"{f.relative_to(REPO)}:{line}: {v!r}"
           for f in _port_files()
           for line, v in _tmp_paths(ast.parse(f.read_text()))]
    assert not bad, bad
    assert [v for _, v in _tmp_paths(ast.parse(
        'def f(d="/tmp/repro_ckpt"):\n    """under /tmp"""\n'))] == [
        "/tmp/repro_ckpt"]


def test_static_check_sees_lazy_imports():
    """The check finds a lazy import inside a function, as the copied
    compiler's ``int8_wire_bytes`` imports were in the reference."""
    src = ("def f():\n"
           "    from repro.parallel.compression import int8_wire_bytes\n"
           "    import triton.language as tl\n"
           "    return importlib.import_module('jax.numpy')\n")
    assert [r for _, r in _imported_roots(ast.parse(src))] == [
        "repro", "triton", "jax"]
    assert [r for _, r in _imported_roots(ast.parse(
        "from .compression import x\nimport repro_torch.core\n"))] == [
        "repro_torch"]


def _require_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_entry_points_raise_without_cuda_unless_asked_for_cpu():
    _require_no_cuda()
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import ContinuousBatcher, main
    from repro_torch.models.model import init_cache, init_params
    cfg = get_smoke_config("granite-moe-3b-a800m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 2, 8)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatcher(cfg, params, n_slots=2, max_len=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--smoke", "--requests", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--smoke", "--sched", "auto", "--online-refit", "--slo-us",
              "40"])
    from repro_torch.launch import profile_serve
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile_serve.main(["--online-refit"])


def test_ep_entry_points_raise_without_cuda_unless_asked_for_cpu(tmp_path):
    _require_no_cuda()
    ckpt = str(tmp_path / "ckpt")
    from repro_torch.ft import harness
    from repro_torch.launch import bench_ep_modes, train
    from repro_torch.launch.mesh import make_mesh, make_test_mesh
    from repro_torch.parallel.comm import VirtualComm
    for fn in (lambda: make_test_mesh(1, 4), lambda: make_mesh((2, 2)),
               lambda: VirtualComm(4),
               lambda: bench_ep_modes.main([]),
               lambda: train.main(["--smoke", "--mesh", "1x4"]),
               lambda: train.main(["--smoke", "--ckpt-dir", ckpt]),
               lambda: harness.main(["--kinds", "slow"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()


def test_unported_families_raise():
    """Every arch of the reference is ported, the audio and vlm ones too;
    an arch or a family the port does not know raises."""
    import dataclasses

    from repro_torch.models.model import init_cache, init_params
    from repro_torch.configs import get_smoke_config, get_config
    cfg = dataclasses.replace(get_smoke_config("granite-moe-3b-a800m"),
                              family="diffusion")
    for fn in (lambda: init_params(cfg, device="cpu"),
               lambda: init_cache(cfg, 1, 8, device="cpu"),
               cfg.param_count):
        with pytest.raises(ValueError, match="diffusion"):
            fn()
    for get in (get_config, get_smoke_config):
        with pytest.raises(NotImplementedError, match="not ported"):
            get("gpt-unknown-7b")
    for arch in ("qwen2-1.5b", "mamba2-1.3b", "recurrentgemma-2b",
                 "hubert-xlarge", "internvl2-26b"):
        assert get_config(arch).param_count() > 0
        smoke = get_smoke_config(arch)
        assert init_params(smoke, device="cpu") and init_cache(
            smoke, 1, 8, device="cpu")


def test_init_params_is_seeded_and_typed():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import init_params
    cfg = get_smoke_config("granite-moe-3b-a800m")          # bf16 compute
    a = init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    b = init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    assert torch.equal(a["blocks"][1]["moe"]["w_in"],
                       b["blocks"][1]["moe"]["w_in"])
    assert a["embed"].dtype == torch.bfloat16
    assert a["blocks"][0]["moe"]["router"].dtype == torch.float32
    n = sum(t.numel() for blk in a["blocks"] for d in blk.values()
            for t in (d.values() if isinstance(d, dict) else [d])
            if t.dim() > 1) + a["embed"].numel() + a["unembed"].numel()
    assert n == cfg.param_count()
