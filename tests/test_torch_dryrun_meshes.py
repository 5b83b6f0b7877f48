"""The dry run on the reference's production meshes, on the CPU.

(a) ``launch.mesh.make_production_mesh`` has the reference's shapes and
axis names (read in a JAX subprocess with 512 forced host devices;
``repro.launch.dryrun`` is never imported here: its first lines set
``XLA_FLAGS``), and the dry run's flags and their choices are the
reference's (read with ``ast``). (b) A production count's rank holds its
blocks of the params and the optimizer state under the reference's specs,
byte for byte, and its batch block. (c) On a counting mesh the forward's
collectives of every tp_sp case that ``tests/test_torch_tp_sp.py`` and
``tests/test_torch_tp_sp_families.py`` hold their processes to equal the
same formulas, at 2x2 and, where the smoke config splits over four ranks,
at 1x4; a dense config's FLOPs summed over the ranks equal its one-card
count. (d) Query heads that the model axis does not split: llama with 6
heads (2 kv) and gemma with 2 at 1x4, in 4 ``gloo`` processes, against
JAX's tp_sp step on 4 forced host devices at 1e-5 in fp32. (e) Rows
repeated over ``model`` (2x2, a global batch of 2, granite): zero1 and
ep_dp across the processes against the one-process step. Then the CLI on
a production mesh, train and serving cells counted, and serving cells of
llama and gemma on 16x16 in tp_sp (gemma's ranks past its 8 heads join
every transfer).
"""

import ast
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import test_torch_tp_sp as TPS  # noqa: E402
import test_torch_tp_sp_families as TPF  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES, ShapeSpec  # noqa: E402
from repro_torch.convert import train_params_from_numpy  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticStream  # noqa
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import steps as St  # noqa: E402
from repro_torch.launch.mesh import (counting_mesh, dist_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402
from repro_torch.parallel.ep import EPConfig  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
GRANITE = "granite-moe-3b-a800m"
SEQ, BATCH, CF = 16, 4, 4.0
OC = adamw.OptConfig(lr=3e-3, warmup_steps=2, total_steps=10)
JAX_TOL, ONE_TOL = 1e-5, 1e-6
# (d): case -> (arch, the smoke config's changes); at M = 4 llama's 6
# heads go 2, 2, 1, 1 and gemma's 2 go 1, 1, 0, 0.
UNEVEN = {"llama_h6": ("llama3.2-3b", {"n_heads": 6, "n_kv_heads": 2}),
          "gemma_h2": ("gemma-2b", {"n_heads": 2})}
UNEVEN_MESH = (1, 4)
# (e): a global batch of 2 on 2x2 splits over data alone.
REPEAT_MODES, REPEAT_MESH, REPEAT_BATCH = ("zero1", "ep_dp"), (2, 2), 2
WORLD = 4


def _uneven_cfg(case):
    arch, over = UNEVEN[case]
    return dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               remat=False, **over)


def _repeat_cfg():
    cfg = dataclasses.replace(get_smoke_config(GRANITE), dtype="float32",
                              remat=False)
    # The one-process step drops no token either.
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=CF))


def _tensors(tree) -> list:
    return [t.detach().clone() for t in adamw.tree_leaves(tree)]


# ---------------------------------------------------------------------------
# (a) the meshes and the CLI
# ---------------------------------------------------------------------------

_JAX_MESH = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
sys.path.insert(0, "src")
from repro.launch.mesh import make_production_mesh
out = {}
for multi in (False, True):
    m = make_production_mesh(multi_pod=multi)
    out[str(multi)] = [list(m.axis_names), list(m.devices.shape)]
print(json.dumps(out))
"""


def test_production_meshes_equal_the_references():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    got = subprocess.run([sys.executable, "-c", _JAX_MESH], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert got.returncode == 0, got.stderr[-2000:]
    ref = json.loads(got.stdout.strip().splitlines()[-1])
    for multi in (False, True):
        names, dims = ref[str(multi)]
        for rank in (0, 1, 17, math.prod(dims) - 1):
            mesh = make_production_mesh(multi_pod=multi, rank=rank)
            assert list(mesh.axis_names) == names
            assert list(mesh.shape.values()) == dims
            assert mesh.coords == S.rank_coords(mesh.shape, rank)
            for axes, comm in mesh.comms.items():
                assert comm.ep == math.prod(mesh.shape[a] for a in axes)
                # Its place among the ranks that differ only in ``axes``.
                peers = [r for r in range(math.prod(dims)) if all(
                    S.rank_coords(mesh.shape, r)[a] == mesh.coords[a]
                    for a in names if a not in axes)]
                assert peers[comm.rank] == rank
            assert mesh.comm is mesh.axes_comm(("model",))
            assert mesh.world.ep == math.prod(dims)


def _reference_flags() -> dict:
    """--flag -> (choices, default, action) of the reference's ``main``."""
    tree = ast.parse((REPO / "src/repro/launch/dryrun.py").read_text())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "add_argument"):
            kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords
                  if k.arg in ("choices", "default", "action")}
            out[node.args[0].value] = (kw.get("choices"), kw.get("default"),
                                       kw.get("action"))
    return out


def test_dryrun_flags_equal_the_references():
    ref = _reference_flags()
    port = {a.option_strings[0]: a for a in D.build_parser()._actions
            if a.option_strings and a.option_strings[0] != "-h"}
    assert set(ref) <= set(port)
    for flag, (choices, default, action) in ref.items():
        a = port[flag]
        if choices is not None:        # the port's --shape names SHAPES too
            assert list(a.choices) == choices, flag
        assert a.default == (default if action != "store_true" else False)
    assert {"--multi-pod-only", "--single-pod-only", "--mode",
            "--ep-mode"} <= set(ref)
    assert D.meshes_of() == ["16x16", "2x16x16"]
    assert D.meshes_of(single_pod_only=True) == ["16x16"]
    assert D.meshes_of(multi_pod_only=True) == ["2x16x16"]
    assert D.meshes_of("1x1") == ["1x1"]


# ---------------------------------------------------------------------------
# (b) a production count's blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
def test_a_production_counts_rank_holds_the_references_blocks(multi):
    """granite at full width cut to 2 layers, ``train_4k``: the argument
    bytes of rank 0's count in each mode equal its blocks of every param
    (bf16) and of m, v and master (fp32) under the reference's specs, and
    of the batch."""
    import jax
    from repro.configs import get_config as jget
    from repro.models import model as JM
    from repro.parallel.sharding import ShardingRules as JRules
    cfg = dataclasses.replace(get_config(GRANITE), n_layers=2)
    jcfg = dataclasses.replace(jget(GRANITE), n_layers=2)
    leaves = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
        lambda: JM.init_params(jcfg, jax.random.PRNGKey(0))))[0]
    mesh = make_production_mesh(multi_pod=multi)
    sp = SHAPES["train_4k"]
    for mode in St.MODES:
        ref = JRules(jcfg, mesh, fsdp=False, mode=mode)
        want = 0
        for path, leaf in leaves:
            for spec, item in ((ref.param_spec(path, leaf.shape), 2),
                               (ref.opt_state_spec(path, leaf.shape),
                                3 * 4)):
                want += item * math.prod(S.block_shape(
                    leaf.shape, tuple(spec) + (None,) * (
                        len(leaf.shape) - len(spec)), mesh))
        bspec = ref.batch_spec({"tokens": jax.ShapeDtypeStruct(
            (sp.global_batch, sp.seq_len), "int32")})
        tokens = math.prod(S.block_shape(
            (sp.global_batch, sp.seq_len), tuple(bspec["tokens"]), mesh))
        want += 2 * 8 * tokens                  # tokens, labels: int64
        rf, _ = D.count_cell(cfg, sp, make_production_mesh(multi_pod=multi),
                             **D.step_policy(cfg, mode))
        assert rf.arg_bytes == want, mode
        assert rf.chips == (512 if multi else 256)
        assert rf.mesh == ("2x16x16" if multi else "16x16")


# ---------------------------------------------------------------------------
# (c) the counting mesh against the processes' formulas, and FLOPs
# ---------------------------------------------------------------------------


def _meta_batch(batch: dict) -> dict:
    return {k: torch.empty(tuple(v.shape), dtype=(
        torch.long if k in ("tokens", "labels") else torch.float32),
        device="meta") for k, v in batch.items()}


def _count_forward(cfg, kw, dims, batch, mode="tp_sp", ep=None, **step):
    """Rank 0's step of ``cfg`` on a counting mesh of ``dims``, on meta:
    its forward's collectives by kind and bytes."""
    mesh = counting_mesh(dims)
    fns = St.make_steps(cfg, mesh, opt=OC, mode=mode, ep=ep, **kw, **step)
    params = S.own_params(fns.rules, adamw.cast_params(
        M.init_params(cfg, device="meta"), torch.float32), mesh)
    state = adamw.init_opt_state(params, fns.rules, mesh)
    mesh.comm.stats.reset()
    fns.train_step(params, state, S.batch_block(fns.rules,
                                                _meta_batch(batch), mesh))
    return dict(mesh.comm.stats.counts), mesh.comm.stats.bytes


def _moe_cases():
    return [(c, r) for c in TPS.CASES if c.startswith("gran")
            for r in (False, True)]


@pytest.mark.parametrize("case,remat", _moe_cases())
def test_counting_mesh_equals_the_moe_processes_formula(case, remat):
    """``test_torch_tp_sp.py``'s granite cases at 2x2 (its smoke config's
    6 experts do not split over 4 ranks)."""
    cfg, kw = TPS._case(case, remat)
    batch = {"tokens": torch.zeros((BATCH, SEQ)),
             "labels": torch.zeros((BATCH, SEQ))}
    got, _ = _count_forward(cfg, kw, TPS.MESH, batch,
                            ep=EPConfig(mode="hyperparallel",
                                        capacity_factor=CF))
    assert got == TPS._expected_counts(case, remat)


FAMILY_MESHES = {(2, 2): list(TPF.CASES),
                 # At M = 4: the families whose smoke widths split.
                 (1, 4): ["llama", "qwen2", "olmo", "gemma", "gemma_noseq",
                          "mamba2", "recurrentgemma_fsdp", "hubert"]}


@pytest.mark.parametrize("dims,case", [(d, c) for d, cs in
                                       FAMILY_MESHES.items() for c in cs])
def test_counting_mesh_equals_the_families_formula(dims, case, monkeypatch):
    """Every case of ``test_torch_tp_sp_families.py``, with and without
    remat: collectives by kind and bytes, the formula evaluated at
    ``dims``."""
    monkeypatch.setattr(TPF, "MESH", dims)
    monkeypatch.setattr(TPF, "_shape", lambda d=dims: dict(
        zip(("data", "model"), d)))
    arch = TPF.CASES[case][0]
    batch = {k: torch.from_numpy(v) for k, v in TPF._batch_np(arch).items()}
    for remat in (False, True):
        cfg, kw = TPF._case(case, remat)
        counts, nbytes = _count_forward(cfg, kw, dims, batch)
        recs = TPF._expected(case, remat)
        want = {}
        for kind, _ in recs:
            want[kind] = want.get(kind, 0) + 1
        assert counts == want, remat
        assert nbytes == sum(n for _, n in recs), remat


@pytest.mark.parametrize("mode", St.MODES)
def test_dense_flops_summed_over_the_ranks_equal_the_one_card_count(mode):
    """llama's smoke config at 2x2 (every head, kv head, MLP channel and
    row splits): the four ranks' counted FLOPs add up to the 1x1 count."""
    cfg = get_smoke_config("llama3.2-3b")
    sp = ShapeSpec("train_4k", SEQ, BATCH, "train")
    one, _ = D.count_cell(cfg, sp)
    ranks = [D.count_cell(cfg, sp, counting_mesh((2, 2), r),
                          **D.step_policy(cfg, mode))[0] for r in range(4)]
    assert sum(rf.flops_per_device for rf in ranks) == one.flops_per_device
    assert all(rf.chips == 4 and rf.collective_bytes > 0 for rf in ranks)


def test_backward_transfers_are_counted_beside_the_forward():
    """On a counting mesh every transfer counts, the transposes and the
    optimizer's included; the forward's counts stay as they were."""
    cfg = get_smoke_config("llama3.2-3b")
    sp = ShapeSpec("train_4k", SEQ, BATCH, "train")
    rf, _ = D.count_cell(cfg, sp, counting_mesh((2, 2)),
                         **D.step_policy(cfg, "tp_sp"))
    fwd = rf.coll_forward
    assert rf.collective_bytes > fwd["bytes"] > 0
    # Each all-gather of the forward transposes to a reduce-scatter.
    assert rf.coll_counts["reduce-scatter"] >= (
        fwd["counts"]["reduce-scatter"] + fwd["counts"]["all-gather"] - 2)
    assert rf.row()["collectives_forward"] == fwd


# ---------------------------------------------------------------------------
# (d), (e) across processes
# ---------------------------------------------------------------------------

_JAX = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.launch import steps as St
from repro.launch.mesh import make_test_mesh
from repro.optim import adamw

d = sys.argv[1]
CASES = json.loads(sys.argv[2])
mesh = make_test_mesh(1, 4)
oc = adamw.OptConfig(lr=3e-3, warmup_steps=2, total_steps=10)
out = {}

def key(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)

for case, (arch, over) in CASES.items():
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              remat=False, **over)
    with np.load(os.path.join(d, f"params_{case}.npz")) as z:
        p0 = {}
        for k, v in z.items():
            node, parts = p0, k.split("/")[1:]
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(v)
    with np.load(os.path.join(d, "batch.npz")) as z:
        b = {k: jnp.asarray(v) for k, v in z.items()}
    box = {}
    def hook(g, box=box):
        box["g"] = g
        return g
    fns = St.make_steps(cfg, mesh, opt=oc, mode="tp_sp",
                        grad_transform=hook)
    def step(p, s, b, fns=fns, box=box):
        p1, s1, m = fns.train_step(p, s, b)
        return m, box["g"]
    with jax.set_mesh(mesh):
        m, g = jax.jit(step)(p0, adamw.init_opt_state(p0), b)
    out[f"{case}/loss"] = np.asarray(m["loss"])
    for path, leaf in jax.tree_util.tree_flatten_with_path(g)[0]:
        out[f"{case}/grads/{key(path)}"] = np.asarray(leaf)
np.savez(os.path.join(d, "jax.npz"), **out)
print("JAX_OK")
"""


def _jax_params(case) -> dict:
    """The reference's init (seed 0) of a case's config, flat."""
    import jax
    from repro.configs import get_smoke_config as jget_smoke
    from repro.models import model as JM
    arch, over = UNEVEN[case]
    jcfg = dataclasses.replace(jget_smoke(arch), dtype="float32", **over)
    return {"params/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                                 for k in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                JM.init_params(jcfg, jax.random.PRNGKey(0)))[0]}


def _unflatten(flat: dict, prefix: str) -> dict:
    out: dict = {}
    for k, v in flat.items():
        if not k.startswith(prefix + "/"):
            continue
        node, parts = out, k[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _whole_batch(d, batch=BATCH) -> dict:
    with np.load(os.path.join(d, "batch.npz")) as z:
        return {k: torch.from_numpy(v[:batch]).long() for k, v in z.items()}


def _uneven_params(d, case):
    with np.load(os.path.join(d, f"params_{case}.npz")) as z:
        return train_params_from_numpy(_unflatten(dict(z), "params"),
                                       _uneven_cfg(case), "cpu")


def _repeat_params():
    cfg = _repeat_cfg()
    return adamw.cast_params(M.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"), torch.float32)


def _rank_step(cfg, mesh, params, batch, **kw):
    """This rank's step from the whole ``params`` and ``batch``: its loss
    and reduced grads (its blocks)."""
    seen = {}

    def hook(g):
        seen["g"] = _tensors(g)
        return g
    fns = St.make_steps(cfg, mesh, opt=OC, grad_transform=hook, **kw)
    params = S.own_params(fns.rules, params, mesh)
    state = adamw.init_opt_state(params, fns.rules, mesh)
    _, _, m = fns.train_step(params, state,
                             S.batch_block(fns.rules, batch, mesh))
    return float(m["loss"]), seen["g"]


def _worker(rank, init, d):
    dist.init_process_group("gloo", init_method=init, world_size=WORLD,
                            rank=rank)
    torch.set_num_threads(1)
    try:
        out = {}
        mesh = dist_mesh(UNEVEN_MESH)
        for case in UNEVEN:
            loss, grads = _rank_step(_uneven_cfg(case), mesh,
                                     _uneven_params(d, case),
                                     _whole_batch(d), mode="tp_sp")
            out[f"{case}/loss"] = np.float64(loss)
            for i, g in enumerate(grads):
                out[f"{case}/grad/{i}"] = g.numpy()
        mesh = dist_mesh(REPEAT_MESH)
        for mode in REPEAT_MODES:
            loss, grads = _rank_step(
                _repeat_cfg(), mesh, _repeat_params(),
                _whole_batch(d, REPEAT_BATCH), mode=mode,
                ep=EPConfig(mode="hyperparallel", capacity_factor=CF),
                global_batch=REPEAT_BATCH)
            out[f"{mode}/loss"] = np.float64(loss)
            for i, g in enumerate(grads):
                out[f"{mode}/grad/{i}"] = g.numpy()
        np.savez(os.path.join(d, f"rank{rank}.npz"), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX steps (a subprocess) beside the 4 processes' steps."""
    d = tmp_path_factory.mktemp("dryrun_meshes")
    for case in UNEVEN:
        np.savez(d / f"params_{case}.npz", **_jax_params(case))
    np.savez(d / "batch.npz", **SyntheticStream(DataConfig(
        128, SEQ, BATCH)).global_batch_np(0))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", _JAX, str(d),
                             json.dumps(UNEVEN)], cwd=str(REPO), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        mp.start_processes(_worker, args=(f"file://{d / 'init'}", str(d)),
                           nprocs=WORLD, join=True, start_method="spawn")
        ranks = []
        for r in range(WORLD):
            with np.load(d / f"rank{r}.npz") as z:
                ranks.append(dict(z))
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert "JAX_OK" in out, err[-3000:]
    with np.load(d / "jax.npz") as z:
        ref = dict(z)
    return d, ref, ranks


def _assemble(ranks, tag, specs, dims):
    shape = dict(zip(("data", "model"), dims))
    return [S.assemble([torch.from_numpy(r[f"{tag}/grad/{i}"])
                        for r in ranks], spec, shape)
            for i, spec in enumerate(specs)]


def _whole_specs(cfg, mode, dims):
    fake = type("Shape", (), {"shape": dict(zip(("data", "model"), dims)),
                              "axis_names": ("data", "model")})()
    rules = S.ShardingRules(cfg, fake, mode=mode)
    return S.param_specs(rules, M.init_params(cfg, device="meta"))


@pytest.mark.parametrize("case", list(UNEVEN))
def test_uneven_heads_match_jax(runs, case):
    """Step 1's loss and the grads assembled from the ranks' blocks
    within 1e-5 of JAX's tp_sp step; the ranks share one loss."""
    _, ref, ranks = runs
    cfg = _uneven_cfg(case)
    losses = {float(r[f"{case}/loss"]) for r in ranks}
    assert len(losses) == 1
    np.testing.assert_allclose(losses.pop(), float(ref[f"{case}/loss"]),
                               rtol=JAX_TOL, atol=JAX_TOL)
    want = adamw.tree_leaves(train_params_from_numpy(
        _unflatten(ref, f"{case}/grads"), cfg, "cpu"))
    got = _assemble(ranks, case, _whole_specs(cfg, "tp_sp", UNEVEN_MESH),
                    UNEVEN_MESH)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=JAX_TOL,
                                   atol=JAX_TOL)


def test_uneven_heads_go_to_the_first_ranks():
    """⌈H/M⌉ heads on the first H mod M ranks, ⌊H/M⌋ on the rest, each
    rank's kv heads those its query heads read; ``wq``/``bq``/``wo`` are
    gathered whole where their spec splits them."""
    from repro_torch.parallel.tp import TensorParallel
    for case, want in (("llama_h6", [(0, 2), (2, 4), (4, 5), (5, 6)]),
                       ("gemma_h2", [(0, 1), (1, 2), (2, 2), (2, 2)])):
        cfg = _uneven_cfg(case)
        for r in range(4):
            tp = TensorParallel(counting_mesh(UNEVEN_MESH, r), S.ShardingRules(
                cfg, counting_mesh(UNEVEN_MESH), mode="tp_sp", fsdp=False))
            assert tp.head_range(cfg.n_heads) == want[r]
            lo, hi = want[r]
            g = cfg.n_heads // cfg.n_kv_heads
            sel = tp.kv_select(cfg.n_heads, cfg.n_kv_heads)
            k_lo = tp.kv_range(cfg.n_heads, cfg.n_kv_heads)[0]
            assert (sel + k_lo).tolist() == [h // g for h in range(lo, hi)]
            assert {("attn", "wq"), ("attn", "wo")} <= set(tp.whole)


@pytest.mark.parametrize("mode", REPEAT_MODES)
def test_repeated_rows_match_the_one_process_step(runs, mode):
    """B = 2 on 2x2: each data group's row on both ranks of its model
    group. Loss within 1e-5 and the reduced grads within 1e-6 of one
    process's step on the whole batch."""
    d, _, ranks = runs
    cfg = _repeat_cfg()
    seen = {}

    def hook(g):
        seen["g"] = _tensors(g)
        return g
    params = _repeat_params()
    _, _, m = St.make_train_step(cfg, OC, grad_transform=hook)(
        params, adamw.init_opt_state(params), _whole_batch(d, REPEAT_BATCH))
    losses = {float(r[f"{mode}/loss"]) for r in ranks}
    assert len(losses) == 1
    np.testing.assert_allclose(losses.pop(), float(m["loss"]),
                               rtol=JAX_TOL, atol=JAX_TOL)
    got = _assemble(ranks, mode, _whole_specs(cfg, mode, REPEAT_MESH),
                    REPEAT_MESH)
    for g, w in zip(got, seen["g"], strict=True):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=ONE_TOL,
                                   atol=ONE_TOL)
    rules = S.ShardingRules(cfg, counting_mesh(REPEAT_MESH), mode=mode)
    assert rules.batch_spec({"labels": (REPEAT_BATCH, SEQ)})["labels"] == \
        ("data", None)


@pytest.mark.parametrize("mode", REPEAT_MODES)
def test_repeated_rows_route_each_ranks_chunk_once(mode):
    """On a counting mesh of (e)'s shape the rank routes its sequence chunk
    of its group's row, S / M tokens, as the reference's ``x_spec`` places
    them: every ring step's ``gmm_swiglu`` call takes the pair capacity of
    that many tokens, not of the group's rows routed again on each rank."""
    from repro_torch.kernels import work
    from repro_torch.parallel.ep import _pair_capacity
    cfg = _repeat_cfg()
    m = REPEAT_MESH[1]
    sp = ShapeSpec("train_4k", SEQ, REPEAT_BATCH, "train")
    rf, _ = D.count_cell(cfg, sp, counting_mesh(REPEAT_MESH), mode=mode,
                         ep=EPConfig(mode="hyperparallel",
                                     capacity_factor=CF))
    mc = cfg.moe
    C = _pair_capacity(SEQ // m, mc, m, CF)
    calls = cfg.n_layers * m                   # a call a ring step a layer
    flops = work.gmm_work(mc.e_total // m, C, cfg.d_model, mc.d_expert,
                          torch.float32, two=True)[1]
    assert rf.kernels["gmm_swiglu"] == {
        "calls": calls, "flops": calls * flops, "bytes": calls * work.gmm_work(
            mc.e_total // m, C, cfg.d_model, mc.d_expert, torch.float32,
            two=True)[0]}


# ---------------------------------------------------------------------------
# the CLI on a production mesh
# ---------------------------------------------------------------------------


def test_cli_counts_train_cells_and_lists_serving_ones_pending(tmp_path,
                                                                monkeypatch):
    """Every cell of granite, cut to 2 layers, on 16x16 in ep_dp: the
    train step, the prefill_32k and the decode_32k cells are all counted
    (256 chips, per-device FLOPs that cover the step: FLOPs a device x
    chips >= model_flops - lookup_flops), with 0 failures and no list of
    pending cells: the serving steps run on a process mesh too."""
    cut = dataclasses.replace(get_config(GRANITE), n_layers=2)
    monkeypatch.setattr(D, "get_config", lambda arch: cut)
    out = tmp_path / "dry.json"
    rows, failures = D.main(["--arch", GRANITE, "--single-pod-only",
                             "--mode", "ep_dp", "--ep-mode", "baseline",
                             "--out", str(out)])
    data = json.loads(out.read_text())
    assert not failures and data["failures"] == []
    assert "pending" not in data
    assert [r["shape"] for r in rows] == ["train_4k", "prefill_32k",
                                          "decode_32k"]
    for row in rows:
        assert (row["chips"], row["mesh"], row["mode"], row["ep_mode"]) \
            == (256, "16x16", "ep_dp", "baseline")
        floor = row["model_flops"] - D.lookup_flops(cut, row["shape"])
        assert row["flops_per_dev"] * row["chips"] >= floor
        assert set(row["collectives"]) >= {"all-to-all", "all-gather"}


# gemma-2b's 8 query heads over 16 ranks: ranks 8 to 15 hold none.
SERVE_CELLS = {"llama3.2-3b": (0,), "gemma-2b": (0, 8)}


@pytest.mark.parametrize("arch", list(SERVE_CELLS))
def test_decode_cell_counted_on_the_production_mesh(arch):
    """decode_32k of ``arch`` (cut to 2 layers) on 16x16 in tp_sp: rank 0's
    decode step over its cache blocks counts FLOPs that cover the step, a
    rank's cache block is a 16th of the slots of its group's rows, and
    gemma's rank 8, which holds no query head, makes the same transfers
    with the same bytes as rank 0."""
    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    sp = SHAPES["decode_32k"]
    rfs = [D.count_cell(cfg, sp, counting_mesh((16, 16), rank),
                        **D.step_policy(cfg))[0] for rank in SERVE_CELLS[arch]]
    rf = rfs[0]
    floor = rf.model_flops_global - D.lookup_flops(cfg, sp)
    assert rf.flops_per_device * rf.chips >= floor
    cache = 2 * cfg.n_layers * (sp.global_batch // 16) * (sp.seq_len // 16) \
        * cfg.n_kv_heads * cfg.hd * 2
    assert rf.arg_bytes > cache
    assert {"all-gather", "all-reduce"} <= set(rf.coll_counts)
    for other in rfs[1:]:
        assert other.coll_counts == rf.coll_counts
        assert other.collective_bytes == rf.collective_bytes
        assert other.coll_forward == rf.coll_forward
