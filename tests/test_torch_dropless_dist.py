"""Dropless training across a process mesh on the CPU: 4 ``gloo``
processes, one rank each, on mesh 2x2 (``dist_mesh((2, 2))``), granite's
smoke config in fp32, ``make_steps(dropless=DroplessConfig(ep=2,
bucket=4))`` in tp_sp (with and without ``seq_parallel``), zero1 and
ep_dp on 4 rows, and zero1 on 2 rows, which repeat over ``model``. Every
rank gathers the whole batch and runs the fragment over it
(``launch.dropless.MeshRows``).

One JAX subprocess (4 forced host devices) runs the reference's
``make_steps(dropless=...)`` on ``make_test_mesh(2, 2)`` for every case,
two steps on the same batch through plain ``jax.jit`` under
``jax.set_mesh``, its process cache new for each case (two subprocesses
side by side); one spawn of 4 processes runs the port's beside them from
the same params. Both steps' losses and step 0's reduced grads, assembled
from the ranks' blocks, must agree within 1e-5, and the params after step
0 through those grads; every rank's ``ssc_*``
metrics of each step must equal the reference's (2 x layers lookups a
step, all misses on step 0; the update moves some tokens' routing across
a bucket edge, so step 1 compiles again in both packages) and its SSC
keys the reference cache's. Under remat each step makes the same lookups,
and ``train --nproc 4 --mesh 2x2 --dropless`` trains.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import repro_torch.launch.dropless as tdl  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import train_params_from_numpy  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticStream  # noqa
from repro_torch.launch import steps as St  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.mesh import dist_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402
from repro_torch.parallel.ep import EPConfig  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCH = "granite-moe-3b-a800m"
MESH, WORLD = (2, 2), 4
SEQ, CF = 16, 8.0
# case -> (mode, rows, make_steps keywords)
CASES = {"tp_sp": ("tp_sp", 4, {}),
         "tp_sp_noseq": ("tp_sp", 4, {"seq_parallel": False}),
         "zero1": ("zero1", 4, {}),
         "ep_dp": ("ep_dp", 4, {}),
         "zero1_repeat": ("zero1", 2, {})}
DC = dict(ep=2, bucket=4)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
TOL = 1e-5


def _cfg(remat=False):
    return dataclasses.replace(get_smoke_config(ARCH), dtype="float32",
                               remat=remat)


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


# The JAX cases run in two subprocesses side by side, these in the first
# (each case's jit takes about as long).
JAX_FIRST = ("tp_sp", "tp_sp_noseq", "zero1_repeat")


def _tensors(tree) -> list:
    return [t.detach().clone() for t in adamw.tree_leaves(tree)]


_JAX = r"""
import dataclasses, json, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
import repro.launch.dropless as jdl
from repro.configs import get_smoke_config
from repro.data.pipeline import DataConfig, SyntheticStream
from repro.launch import steps as St
from repro.launch.mesh import make_test_mesh
from repro.models import model as M
from repro.optim import adamw
from repro.parallel.ep import EPConfig

d, cases, name = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
SEQ, CF = 16, 8.0
cfg = dataclasses.replace(get_smoke_config("granite-moe-3b-a800m"),
                          dtype="float32", remat=False)
mesh = make_test_mesh(2, 2)
oc = adamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
with np.load(os.path.join(d, "params.npz")) as z:
    flat = dict(z)

def key(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)

def tree(prefix, t):
    return {f"{prefix}/{key(p)}": np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}

p0 = jax.tree_util.tree_map_with_path(
    lambda path, _: jnp.asarray(flat["params/" + key(path)]),
    M.init_params(cfg, jax.random.PRNGKey(0)))
out = {}
for case, (mode, rows, kw) in cases.items():
    jdl._PROCESS_CACHE = None            # each case compiles afresh
    box = {}
    def hook(g, box=box):
        box["g"] = g
        return g
    fns = St.make_steps(cfg, mesh, opt=oc, ep=EPConfig(capacity_factor=CF),
                        mode=mode, grad_transform=hook,
                        dropless=jdl.DroplessConfig(ep=2, bucket=4), **kw)
    def step(p, s, b, fns=fns, box=box):
        p1, s1, m = fns.train_step(p, s, b)
        return p1, s1, m["loss"], box["g"]
    b = {k: jnp.asarray(v) for k, v in SyntheticStream(
        DataConfig(cfg.vocab, SEQ, rows)).global_batch_np(0).items()}
    p, s = p0, adamw.init_opt_state(p0)
    res = {"loss": [], "ssc": []}
    with jax.set_mesh(mesh):
        jstep = jax.jit(step)
        for i in range(2):
            p, s, loss, g = jstep(p, s, b)
            res["loss"].append(float(loss))
            res["ssc"].append({f"ssc_{k}": float(v) for k, v in
                               fns.dropless.step_stats().items()})
            if i == 0:
                res["p"], res["grads"] = tree("p", p), tree("g", g)
    res["keys"] = list(fns.dropless.cache._cache)
    out[case] = res
with open(os.path.join(d, name), "wb") as f:
    pickle.dump(out, f)
print("JAX_OK")
"""


def _params(d):
    with np.load(os.path.join(d, "params.npz")) as z:
        return train_params_from_numpy(_unflatten(dict(z), "params"),
                                       _cfg(), "cpu")


def _run(case, mesh, d, remat=False):
    """Two dropless steps of ``case`` on this rank: each step's loss and
    ``ssc_*`` metrics, step 0's reduced grads and the params after it (the
    rank's blocks), and the SSC cache's keys."""
    mode, rows, kw = CASES[case]
    cfg = _cfg(remat)
    seen = {}

    def hook(g):
        seen.setdefault("g", _tensors(g))
        return g
    tdl._PROCESS_CACHE = None             # each case compiles afresh
    fns = St.make_steps(cfg, mesh, opt=adamw.OptConfig(**OPT),
                        ep=EPConfig(capacity_factor=CF), mode=mode,
                        grad_transform=hook, global_batch=rows,
                        dropless=tdl.DroplessConfig(**DC), **kw)
    params = S.own_params(fns.rules, _params(d), mesh)
    state = adamw.init_opt_state(params, fns.rules, mesh)
    batch = S.batch_block(fns.rules, SyntheticStream(DataConfig(
        cfg.vocab, SEQ, rows)).batch(0, "cpu"), mesh)
    out = {"loss": [], "ssc": []}
    for _ in range(2):
        params, state, m = fns.train_step(params, state, batch)
        out["loss"].append(float(m["loss"]))
        out["ssc"].append({k: float(v) for k, v in m.items()
                           if k.startswith("ssc_")})
        out.setdefault("p", _tensors(params))
    out["grads"] = seen["g"]
    out["keys"] = list(fns.dropless.cache._cache)
    return out


def _worker(rank, init, d):
    dist.init_process_group("gloo", init_method=init, world_size=WORLD,
                            rank=rank)
    torch.set_num_threads(1)
    try:
        mesh = dist_mesh(MESH)
        out = {case: _run(case, mesh, d) for case in CASES}
        out["tp_sp_remat"] = _run("tp_sp", mesh, d, remat=True)
        torch.save(out, os.path.join(d, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's steps (two subprocesses) beside the 4 processes'."""
    import json

    import jax
    from repro.configs import get_smoke_config as jget_smoke
    from repro.models import model as JM
    d = tmp_path_factory.mktemp("dropless_dist")
    jcfg = dataclasses.replace(jget_smoke(ARCH), dtype="float32")
    np.savez(d / "params.npz", **{
        "params/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                             for k in path): np.asarray(leaf, np.float32)
        for path, leaf in jax.tree_util.tree_flatten_with_path(
            JM.init_params(jcfg, jax.random.PRNGKey(0)))[0]})
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    parts = [{k: v for k, v in CASES.items() if k in JAX_FIRST},
             {k: v for k, v in CASES.items() if k not in JAX_FIRST}]
    procs = [subprocess.Popen([sys.executable, "-c", _JAX, str(d),
                               json.dumps(part), f"jax{i}.pkl"],
                              cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i, part in enumerate(parts)]
    ref = {}
    try:
        mp.start_processes(_worker, args=(f"file://{d / 'init'}", str(d)),
                           nprocs=WORLD, join=True, start_method="spawn")
        ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
                 for r in range(WORLD)]
        for i, proc in enumerate(procs):
            out, err = proc.communicate(timeout=400)
            assert "JAX_OK" in out, err[-3000:]
            with open(d / f"jax{i}.pkl", "rb") as f:
                ref.update(pickle.load(f))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    return d, ref, ranks


def _specs(mode):
    """Each leaf's param spec of the whole tree in ``mode``."""
    cfg = _cfg()
    rules = S.ShardingRules(cfg, type("FakeMesh", (), {
        "shape": dict(zip(("data", "model"), MESH)),
        "axis_names": ("data", "model")})(), mode=mode)
    return S.param_specs(rules, M.init_params(cfg, device="meta"))


def _assemble(blocks_by_rank, specs):
    shape = dict(zip(("data", "model"), MESH))
    return [S.assemble([b[i] for b in blocks_by_rank], spec, shape)
            for i, spec in enumerate(specs)]


def _want(flat, prefix):
    return adamw.tree_leaves(train_params_from_numpy(
        _unflatten(flat, prefix), _cfg(), "cpu"))


def _close(got, want, what):
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=f"{what} leaf {i}")


def _updated(d, grads) -> list:
    """The port's one-process AdamW step from the initial params with
    ``grads`` (leaves)."""
    params = _params(d)
    it = iter(grads)
    adamw.apply_updates(params, adamw.tree_map(lambda _: next(it), params),
                        adamw.init_opt_state(params), adamw.OptConfig(**OPT))
    return adamw.tree_leaves(params)


@pytest.mark.parametrize("case", list(CASES))
def test_steps_match_the_reference(runs, case):
    """Both steps' losses (the mean over the ranks, equal on every rank)
    and step 0's reduced grads, assembled from the ranks' blocks, within
    1e-5 of the reference's jitted steps on its 2x2 mesh. The params after
    step 0: the processes' update, assembled, bit-equal to the port's
    one-process AdamW of the same grads, and that AdamW of the reference's
    grads within 1e-5 of the reference's params. (A grad at rounding level,
    1e-9 with either sign, takes Adam's first step to either side: the
    params are held through their grads, as ``test_torch_dist_train.py``
    holds them.)"""
    d, ref, ranks = runs
    j = ref[case]
    specs = _specs(CASES[case][0])
    for i in range(2):
        losses = {r[case]["loss"][i] for r in ranks}
        assert len(losses) == 1
        np.testing.assert_allclose(losses.pop(), j["loss"][i], rtol=TOL,
                                   atol=TOL)
    grads = _assemble([r[case]["grads"] for r in ranks], specs)
    want = _want(j["grads"], "g")
    _close(grads, want, "grad")
    got = _assemble([r[case]["p"] for r in ranks], specs)
    for i, (a, b) in enumerate(zip(got, _updated(d, grads), strict=True)):
        assert torch.equal(a, b), i
    _close(_updated(d, want), _want(j["p"], "p"), "params after step 0")


@pytest.mark.parametrize("case", list(CASES))
def test_every_rank_looks_up_the_reference_schedules(runs, case):
    """Each rank's ``ssc_*`` metrics of each step equal the reference's
    (one forward and one backward schedule a layer, all compiled on step
    0), and its cache holds the reference cache's keys, in its order."""
    _, ref, ranks = runs
    j = ref[case]
    n = 2 * _cfg().n_layers
    assert j["ssc"][0]["ssc_misses"] == n and j["ssc"][0]["ssc_hits"] == 0
    assert all(s["ssc_hits"] + s["ssc_misses"] == n for s in j["ssc"])
    for r in ranks:
        assert r[case]["ssc"] == j["ssc"]
        assert r[case]["keys"] == j["keys"]


def test_remat_runs_each_fragment_once_a_step(runs):
    """Under per-layer remat the fragment's forward runs once a layer a
    step on every rank: each step's lookups are the reference's without
    remat (2 x layers), and so are the losses."""
    _, ref, ranks = runs
    for r in ranks:
        assert r["tp_sp_remat"]["ssc"] == ref["tp_sp"]["ssc"]
        np.testing.assert_allclose(r["tp_sp_remat"]["loss"],
                                   ref["tp_sp"]["loss"], rtol=TOL, atol=TOL)


def test_launcher_trains_dropless_across_processes(monkeypatch):
    """``train --nproc 4 --mesh 2x2 --dropless`` (ep_dp, the reference
    README's mode): finite losses, and every rank's record holds its own
    ``ssc_*`` counters, 2 x layers lookups a step, all misses on step 0."""
    monkeypatch.setattr(tdl, "_PROCESS_CACHE", None)
    run = ttrain.main(["--smoke", "--device", "cpu", "--steps", "2",
                       "--seq", "16", "--global-batch", "4", "--nproc", "4",
                       "--mesh", "2x2", "--mode", "ep_dp", "--dropless"])
    assert all(np.isfinite(m["loss"]) for m in run.metrics_log)
    n = 2 * get_smoke_config(ARCH).n_layers
    for r in run.ranks:
        assert len(r["per_step"]) == 2
        assert r["per_step"][0]["ssc_misses"] == n
        assert all(s["ssc_hits"] + s["ssc_misses"] == n
                   for s in r["per_step"])
        assert r["per_step"] == run.ranks[0]["per_step"]
    assert tdl._PROCESS_CACHE is None       # the ranks' caches are theirs
