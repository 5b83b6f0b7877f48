"""Training across processes on the CPU: 4 ``gloo`` processes, one rank
each, on mesh 2x2 in the zero1 and ep_dp modes (``dist_mesh((2, 2))``,
``make_steps`` on each rank's rows, ZeRO-1 optimizer state, the one-writer
checkpoint), granite's smoke config in fp32. Step 1's loss and the reduced
grads, assembled over the ranks, must agree within 1e-5 with JAX's
``make_steps`` step on ``make_test_mesh(2, 2)`` and within 1e-6 with the
port's one-process run over virtual ranks. Both packages' AdamW updates are
applied to JAX's grads (never params compared after steps), and the ZeRO-1
update, assembled, must be bit-equal to the port's replicated one. A
checkpoint the 4 processes save restores bit-equal at 2 processes (mesh
1x2) and in one, and the reference's ``restore`` reads it."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.checkpoint import ckpt as CK  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import (DistTrainLayout, JaxTrainLayout,  # noqa
                                 opt_state_from_numpy,
                                 train_params_from_numpy,
                                 train_params_to_jax)
from repro_torch.data.pipeline import DataConfig, SyntheticStream  # noqa
from repro_torch.launch import steps as St  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.mesh import dist_mesh, make_mesh  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402
from repro_torch.parallel.ep import EPConfig  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCH = "granite-moe-3b-a800m"
WORLD, MESH = 4, (2, 2)
MODES = ("zero1", "ep_dp")
SEQ, BATCH, CF = 16, 4, 4.0          # one row a rank
JAX_TOL, VIRTUAL_TOL = 1e-5, 1e-6
OC = adamw.OptConfig(lr=3e-3, warmup_steps=2, total_steps=10)


def _cfg():
    return dataclasses.replace(get_smoke_config(ARCH), dtype="float32")


def _unflatten(flat: dict, prefix: str) -> dict:
    """The nested JAX tree of the ``prefix/a/b`` keys of an npz."""
    out: dict = {}
    for k, v in flat.items():
        if not k.startswith(prefix + "/"):
            continue
        node, parts = out, k[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _tensors(tree) -> list:
    return [t.detach().clone() for t in adamw.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


_JAX = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.data.pipeline import DataConfig, SyntheticStream
from repro.launch import steps as St
from repro.launch.mesh import make_test_mesh
from repro.models import model as M
from repro.optim import adamw
from repro.parallel.ep import EPConfig

SEQ, BATCH = int(sys.argv[2]), int(sys.argv[3])
cfg = dataclasses.replace(get_smoke_config("granite-moe-3b-a800m"),
                          dtype="float32")
mesh = make_test_mesh(2, 2)
oc = adamw.OptConfig(lr=3e-3, warmup_steps=2, total_steps=10)
p0 = adamw.cast_params(M.init_params(cfg, jax.random.PRNGKey(0)),
                       jnp.float32)
s0 = adamw.init_opt_state(p0)
b = {k: jnp.asarray(v) for k, v in SyntheticStream(
    DataConfig(cfg.vocab, SEQ, BATCH)).global_batch_np(0).items()}
out = {}

def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[f"{prefix}/{key}"] = np.asarray(leaf)

for mode in ("zero1", "ep_dp"):
    box = {}
    def hook(g, box=box):
        box["g"] = g
        return g
    fns = St.make_steps(cfg, mesh, opt=oc, ep=EPConfig(
        mode="hyperparallel", capacity_factor=4.0), mode=mode,
        grad_transform=hook)
    def step(p, s, b, fns=fns, box=box):
        p1, s1, m = fns.train_step(p, s, b)
        return p1, s1, m, box["g"]
    with jax.set_mesh(mesh):
        p1, s1, m, g = jax.jit(step)(p0, s0, b)
    out[f"{mode}/loss"] = np.asarray(m["loss"])
    put(f"{mode}/grads", g)
    put(f"{mode}/p1", p1)
    for k in ("m", "v", "master"):
        put(f"{mode}/{k}", s1[k])
np.savez(sys.argv[1], **out)
print("JAX_OK")
"""


def _params(d, cfg):
    """The reference's initial params (written by the fixture) as the
    port's."""
    with np.load(os.path.join(d, "params.npz")) as z:
        return train_params_from_numpy(_unflatten(dict(z), "params"), cfg,
                                       "cpu")


def _worker(rank, init, d, world, dims, restore_only):
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    torch.set_num_threads(2)
    try:
        cfg = _cfg()
        mesh = dist_mesh(dims)
        out = {}
        for mode in MODES:
            seen = {}

            def hook(g, seen=seen):
                seen["g"] = _tensors(g)
                return g
            fns = St.make_steps(cfg, mesh, opt=OC, ep=EPConfig(
                mode="hyperparallel", capacity_factor=CF), mode=mode,
                grad_transform=hook)
            rules, layout = fns.rules, DistTrainLayout(fns.rules, mesh)
            params = S.own_params(rules, _params(d, cfg), mesh)
            state = adamw.init_opt_state(params, rules, mesh)
            ckpt = os.path.join(d, f"ckpt_{mode}")
            if restore_only:
                layout.restore(CK.latest_step_dir(ckpt), params, state)
            else:
                stream = SyntheticStream(DataConfig(cfg.vocab, SEQ, BATCH),
                                         rules=rules)
                mesh.comm.stats.reset()
                _, _, m = fns.train_step(params, state, stream.sharded_batch(
                    0, mesh, "cpu"))
                out[f"{mode}/loss"] = m["loss"].numpy()
                out[f"{mode}/collectives"] = np.asarray(
                    sum(mesh.comm.stats.counts.values()))
                for i, g in enumerate(seen["g"]):
                    out[f"{mode}/grad/{i}"] = g.numpy()
                CK.save(ckpt, 1, layout.tree(params, state), comm=mesh.world)
            for k, tree in (("p", params), ("m", state["m"]),
                            ("v", state["v"]), ("master", state["master"])):
                for i, t in enumerate(_tensors(tree)):
                    out[f"{mode}/{k}/{i}"] = t.numpy()
        np.savez(os.path.join(d, f"{'r' if restore_only else 's'}{world}_"
                              f"rank{rank}.npz"), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _spawn(d, world, dims, restore_only):
    mp.start_processes(_worker, args=(
        f"file://{d / f'init{world}'}", str(d), world, dims, restore_only),
        nprocs=world, join=True, start_method="spawn")
    tag = "r" if restore_only else "s"
    ranks = []
    for r in range(world):
        with np.load(d / f"{tag}{world}_rank{r}.npz") as z:
            ranks.append(dict(z))
    return ranks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX step (a subprocess with forced host devices) runs beside the
    4 processes' step and save, then 2 processes restore."""
    import jax
    from repro.configs import get_smoke_config as jget_smoke
    from repro.models import model as JM
    from repro.optim import adamw as jadamw
    d = tmp_path_factory.mktemp("dist_train")
    jcfg = dataclasses.replace(jget_smoke(ARCH), dtype="float32")
    p0 = jadamw.cast_params(JM.init_params(jcfg, jax.random.PRNGKey(0)),
                            jax.numpy.float32)
    np.savez(d / "params.npz", **{
        "params/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                             for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(p0)[0]})
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", _JAX, str(d / "jax.npz"),
                             str(SEQ), str(BATCH)], cwd=str(REPO), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        saved = _spawn(d, WORLD, MESH, False)
        restored = _spawn(d, 2, (1, 2), True)
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert "JAX_OK" in out, err[-3000:]
    with np.load(d / "jax.npz") as z:
        ref = dict(z)
    return d, ref, saved, restored


def _mesh_shape(dims):
    names = ("data", "model")
    return dict(zip(names, dims))


def _assemble(ranks, mode, kind, specs, dims):
    """Each leaf of ``kind`` assembled from every rank's block."""
    out = []
    for i, spec in enumerate(specs):
        blocks = [torch.from_numpy(r[f"{mode}/{kind}/{i}"]) for r in ranks]
        out.append(S.assemble(blocks, spec, _mesh_shape(dims)))
    return out


def _specs(mode, dims):
    """(param specs, opt-state specs) of the whole tree on ``dims``."""
    cfg = _cfg()
    from repro_torch.models import model as M
    rules = S.ShardingRules(cfg, type("FakeMesh", (), {
        "shape": _mesh_shape(dims), "axis_names": ("data", "model")})(),
        mode=mode)
    meta = M.init_params(cfg, device="meta")
    return S.param_specs(rules, meta), S.opt_state_specs(rules, meta)


def _virtual(mode, d):
    """The one-process run over virtual ranks: loss and the step's grads."""
    cfg = _cfg()
    seen = {}

    def hook(g):
        seen["g"] = _tensors(g)
        return g
    mesh = make_mesh(MESH, "cpu")
    step = St.make_steps(cfg, mesh, opt=OC, ep=EPConfig(
        mode="hyperparallel", capacity_factor=CF), mode=mode,
        grad_transform=hook).train_step
    params = _params(d, cfg)
    _, _, m = step(params, adamw.init_opt_state(params), SyntheticStream(
        DataConfig(cfg.vocab, SEQ, BATCH)).sharded_batch(0, mesh, "cpu"))
    return float(m["loss"]), seen["g"]


@pytest.mark.parametrize("mode", MODES)
def test_step_loss_and_grads_match_jax_and_the_virtual_ranks(runs, mode):
    d, ref, ranks, _ = runs
    cfg = _cfg()
    pspecs, _ = _specs(mode, MESH)
    losses = [float(r[f"{mode}/loss"]) for r in ranks]
    assert len(set(losses)) == 1               # the mean over the ranks
    grads = _assemble(ranks, mode, "grad", pspecs, MESH)
    want = adamw.tree_leaves(train_params_from_numpy(
        _unflatten(ref, f"{mode}/grads"), cfg, "cpu"))
    np.testing.assert_allclose(losses[0], float(ref[f"{mode}/loss"]),
                               rtol=JAX_TOL, atol=JAX_TOL)
    for g, w in zip(grads, want, strict=True):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=JAX_TOL,
                                   atol=JAX_TOL)
    v_loss, v_grads = _virtual(mode, d)
    np.testing.assert_allclose(losses[0], v_loss, rtol=VIRTUAL_TOL,
                               atol=VIRTUAL_TOL)
    for g, w in zip(grads, v_grads, strict=True):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=VIRTUAL_TOL,
                                   atol=VIRTUAL_TOL)
    assert all(int(r[f"{mode}/collectives"]) > 0 for r in ranks)


@pytest.mark.parametrize("mode", MODES)
def test_updates_of_the_same_grads(runs, mode):
    """Both packages' AdamW updates of JAX's grads agree within 1e-5. The
    4 processes' step updated each rank's ZeRO-1 blocks from its reduced
    grads; assembled, that update is bit-equal to the port's replicated
    update of the same grads, and each rank holds only its blocks."""
    d, ref, ranks, _ = runs
    cfg = _cfg()
    pspecs, ospecs = _specs(mode, MESH)

    def replicated(grads):
        params = _params(d, cfg)
        state = adamw.init_opt_state(params)
        adamw.apply_updates(params, grads, state, OC)
        return {"p": adamw.tree_leaves(params),
                **{k: adamw.tree_leaves(state[k])
                   for k in ("m", "v", "master")}}

    got = replicated(train_params_from_numpy(
        _unflatten(ref, f"{mode}/grads"), cfg, "cpu"))
    jax_state = opt_state_from_numpy(
        {**{k: _unflatten(ref, f"{mode}/{k}") for k in ("m", "v", "master")},
         "step": 1}, cfg, "cpu")
    want = {"p": adamw.tree_leaves(train_params_from_numpy(
        _unflatten(ref, f"{mode}/p1"), cfg, "cpu")),
        **{k: adamw.tree_leaves(jax_state[k]) for k in ("m", "v", "master")}}
    for k in want:
        for a, b in zip(got[k], want[k], strict=True):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=JAX_TOL,
                                       atol=JAX_TOL, err_msg=k)
    grads = _assemble(ranks, mode, "grad", pspecs, MESH)
    it = iter(grads)
    same = replicated(adamw.tree_map(lambda _: next(it), _params(d, cfg)))
    for k in same:
        blocks = _assemble(ranks, mode, k, pspecs if k == "p" else ospecs,
                           MESH)
        for i, (a, b) in enumerate(zip(blocks, same[k], strict=True)):
            assert torch.equal(a, b), (k, i)
    shape = _mesh_shape(MESH)
    for i, (t, spec) in enumerate(zip(same["m"], ospecs)):
        blk = S.block_shape(t.shape, spec, shape)
        for r in ranks:
            for k in ("m", "v", "master"):
                assert r[f"{mode}/{k}/{i}"].shape == blk
    assert any(S.spec_axes(s) for s in ospecs)


@pytest.mark.parametrize("mode", MODES)
def test_checkpoint_restores_at_two_processes_and_one(runs, mode):
    """The 4 processes' checkpoint is in the reference's layout: restored
    at mesh 1x2 and in one process, bit-equal to the assembled state, and
    read by the reference's ``restore``."""
    d, ref, saved, restored = runs
    cfg = _cfg()
    pspecs, ospecs = _specs(mode, MESH)
    step_dir = CK.latest_step_dir(str(d / f"ckpt_{mode}"))
    params = _params(d, cfg)
    state = adamw.init_opt_state(params)
    JaxTrainLayout.restore(step_dir, params, state)
    assert state["step"] == 1
    one = {"p": adamw.tree_leaves(params),
           **{k: adamw.tree_leaves(state[k]) for k in ("m", "v", "master")}}
    p2, o2 = _specs(mode, (1, 2))
    for k in ("p", "m", "v", "master"):
        four = _assemble(saved, mode, k, pspecs if k == "p" else ospecs,
                         MESH)
        two = _assemble(restored, mode, k, p2 if k == "p" else o2, (1, 2))
        for a, b, c in zip(four, two, one[k], strict=True):
            assert torch.equal(a, c) and torch.equal(b, c), k
    from repro.checkpoint import ckpt as jckpt
    like = train_params_to_jax(params)
    jtree = {k: v.numpy() for k, v in CK._flatten(like)}
    (jp, _), _ = jckpt.restore(step_dir, (like, _jax_state_like(state)))
    for path, leaf in CK._flatten(jp):
        np.testing.assert_array_equal(np.asarray(leaf), jtree[path])


def _jax_state_like(state):
    from repro_torch.convert import opt_state_to_jax
    out = opt_state_to_jax(state)
    out["step"] = np.int32(out["step"])
    return out


def test_launcher_refuses_what_the_slice_does_not_cover(tmp_path):
    """NCCL with more ranks than cards raises (never switching to gloo),
    and so does the audio encoder, which trains on features the launcher
    does not feed (in the default mode tp_sp, and named); both before any
    process starts. Every other family trains in tp_sp across processes
    (``tests/test_torch_tp_sp_families.py``)."""
    base = ["--smoke", "--steps", "1", "--seq", "16", "--global-batch", "4"]
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="one rank a card"):
            ttrain.main(base + ["--nproc", "2", "--mesh", "1x2", "--mode",
                                "zero1", "--backend", "nccl"])
    for mode in ([], ["--mode", "tp_sp"]):
        with pytest.raises(ValueError, match="features"):
            ttrain.main(base + ["--arch", "hubert-xlarge", "--nproc", "4",
                                "--mesh", "2x2", "--device", "cpu"] + mode)
    with pytest.raises(SystemExit):
        ttrain.main(base + ["--nproc", "4", "--mesh", "1x2", "--mode",
                            "zero1", "--device", "cpu"])


def test_one_process_mesh_equals_the_one_process_run():
    """``--nproc 1 --mesh 1x1`` gives the one-process run's losses."""
    argv = ["--smoke", "--device", "cpu", "--steps", "2", "--seq", "16",
            "--global-batch", "2", "--mesh", "1x1", "--mode", "zero1"]
    one = ttrain.main(argv)
    dist_run = ttrain.main(argv + ["--nproc", "1"])
    assert [m["loss"] for m in dist_run.metrics_log] == [
        m["loss"] for m in one.metrics_log]
    assert dist_run.ranks[0]["coords"] == {"data": 0, "model": 0}


def test_gloo_transfers_are_timed_by_kind():
    """Over gloo each step's record has the host seconds of each kind of
    transfer (the ring's permutes, zero1's all-to-alls, the grads'
    all-reduce, ZeRO-1's all-gather) beside the counted collectives."""
    run = ttrain.main(["--smoke", "--device", "cpu", "--steps", "2",
                       "--seq", "16", "--global-batch", "2", "--nproc", "2",
                       "--mesh", "1x2", "--mode", "zero1"])
    for m in run.metrics_log:
        kinds = {"all-to-all", "collective-permute", "all-reduce",
                 "all-gather"}
        assert kinds <= set(m["collectives"])
        assert kinds <= set(m["comm_seconds"])
        assert all(s > 0 for s in m["comm_seconds"].values())
