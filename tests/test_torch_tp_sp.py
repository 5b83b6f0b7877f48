"""tp_sp across processes on the CPU: 4 ``gloo`` processes, one rank each,
on mesh 2x2 (``dist_mesh((2, 2))``), the MoE family split over the model
axis (heads, vocabulary, experts, the residual's sequence) and with FSDP
over ``data``, in fp32. Cases: granite's smoke config plain, with
``fsdp=True`` and with ``seq_parallel=False``, and dbrx's (layernorm,
E = 4) with ``fsdp=True``.

One JAX subprocess (4 forced host devices) runs the reference's
``make_steps(mode="tp_sp")`` on ``make_test_mesh(2, 2)`` for every case;
one spawn of 4 processes runs the port's. Step 1's loss and the grads
assembled from the ranks' blocks must agree within 1e-5 with JAX and
within 1e-6 with the port's one-process run over virtual ranks. Both
packages' AdamW is applied to JAX's grads, and the processes' update,
assembled, must be bit-equal to the port's replicated one; each process
holds its spec blocks alone. A second spawn, of 2 processes, restores the
4 processes' checkpoints at mesh 1x2 (also read in one process and by the
reference's ``restore``) and holds each new collective's transpose to the
grads of the same computation done whole. A rank's attention projections
cost 1/M of one process's FLOPs (heads split, not weights gathered), and
the collectives of a step, with and without remat, equal their formula.
"""

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
                                 opt_state_from_numpy, opt_state_to_jax,
                                 train_params_from_numpy,
                                 train_params_to_jax)
from repro_torch.data.pipeline import DataConfig, SyntheticStream  # noqa
from repro_torch.launch import steps as St  # noqa: E402
from repro_torch.launch.mesh import dist_mesh, make_mesh  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402
from repro_torch.parallel.ctx import tensor_parallel_context  # noqa: E402
from repro_torch.parallel.ep import EPConfig  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
GRANITE, DBRX = "granite-moe-3b-a800m", "dbrx-132b"
ARCHS = (GRANITE, DBRX)
# case -> (arch, make_steps keywords)
CASES = {"granite": (GRANITE, {}),
         "granite_fsdp": (GRANITE, {"fsdp": True}),
         "granite_noseq": (GRANITE, {"seq_parallel": False}),
         "dbrx_fsdp": (DBRX, {"fsdp": True})}
SAVED = ("granite", "granite_fsdp")     # checkpointed, restored at 1x2
# Held to the virtual ranks alone: a padded vocabulary of 121 rows, which
# the model axis does not split (the embedding looks up locally, the cross
# entropy runs on each rank's chunk).
ODD_VOCAB = {"granite_v121": (GRANITE, {}),
             "granite_v121_noseq": (GRANITE, {"seq_parallel": False})}
MESH, WORLD = (2, 2), 4
SEQ, BATCH, CF = 16, 4, 4.0
JAX_TOL, VIRTUAL_TOL = 1e-5, 1e-6
OC = adamw.OptConfig(lr=3e-3, warmup_steps=2, total_steps=10)
KINDS = ("all-gather", "reduce-scatter", "all-reduce", "collective-permute",
         "all-to-all")


def _cfg(arch, remat=False):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               remat=remat)


def _shape(dims):
    return dict(zip(("data", "model"), dims))


class _ShapeMesh:
    def __init__(self, dims):
        self.shape = _shape(dims)
        self.axis_names = tuple(self.shape)


def _case(case, remat=False):
    """(config, make_steps keywords) of a case."""
    arch, kw = {**CASES, **ODD_VOCAB}[case]
    cfg = _cfg(arch, remat)
    if case in ODD_VOCAB:
        cfg = dataclasses.replace(cfg, vocab=121, vocab_pad=1)
    return cfg, kw


def _rules(case, dims=MESH):
    cfg, kw = _case(case)
    return S.ShardingRules(cfg, _ShapeMesh(dims), mode="tp_sp",
                           fsdp=kw.get("fsdp"))


def _specs(case, dims=MESH):
    """(param specs, opt-state specs) of the whole tree; in tp_sp the
    same."""
    rules = _rules(case, dims)
    meta = M.init_params(rules.cfg, device="meta")
    return S.param_specs(rules, meta), S.opt_state_specs(rules, meta)


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


def _tensors(tree) -> list:
    return [t.detach().clone() for t in adamw.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _params(d, arch):
    """The reference's initial params (written by the fixture) as the
    port's."""
    with np.load(os.path.join(d, f"params_{arch}.npz")) as z:
        return train_params_from_numpy(_unflatten(dict(z), "params"),
                                       _cfg(arch), "cpu")


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

d, SEQ, BATCH = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
CASES = {"granite": ("granite-moe-3b-a800m", {}),
         "granite_fsdp": ("granite-moe-3b-a800m", {"fsdp": True}),
         "granite_noseq": ("granite-moe-3b-a800m", {"seq_parallel": False}),
         "dbrx_fsdp": ("dbrx-132b", {"fsdp": True})}
mesh = make_test_mesh(2, 2)
oc = adamw.OptConfig(lr=3e-3, warmup_steps=2, total_steps=10)
out = {}

def key(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)

def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[f"{prefix}/{key(path)}"] = np.asarray(leaf)

for case, (arch, kw) in CASES.items():
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              remat=False)
    init = M.init_params(cfg, jax.random.PRNGKey(0))
    with np.load(os.path.join(d, f"params_{arch}.npz")) as z:
        p0 = jax.tree_util.tree_map_with_path(
            lambda path, _: jnp.asarray(z["params/" + key(path)]), init)
    s0 = adamw.init_opt_state(p0)
    b = {k: jnp.asarray(v) for k, v in SyntheticStream(
        DataConfig(cfg.vocab, SEQ, BATCH)).global_batch_np(0).items()}
    box = {}
    def hook(g, box=box):
        box["g"] = g
        return g
    fns = St.make_steps(cfg, mesh, opt=oc, ep=EPConfig(
        mode="hyperparallel", capacity_factor=4.0), mode="tp_sp",
        grad_transform=hook, **kw)
    def step(p, s, b, fns=fns, box=box):
        p1, s1, m = fns.train_step(p, s, b)
        return p1, s1, m, box["g"]
    with jax.set_mesh(mesh):
        p1, s1, m, g = jax.jit(step)(p0, s0, b)
    out[f"{case}/loss"] = np.asarray(m["loss"])
    put(f"{case}/grads", g)
    put(f"{case}/p1", p1)
    for k in ("m", "v", "master"):
        put(f"{case}/{k}", s1[k])
np.savez(os.path.join(d, "jax.npz"), **out)
print("JAX_OK")
"""


def _step(case, mesh, d, remat=False):
    """One tp_sp step of ``case`` on ``mesh`` from the reference's params
    (an odd vocabulary's: the port's init): (loss, the grads the update
    took, params, state, step counts, rules)."""
    cfg, kw = _case(case, remat)
    seen = {}

    def hook(g):
        seen["g"] = _tensors(g)
        return g
    fns = St.make_steps(cfg, mesh, opt=OC, ep=EPConfig(
        mode="hyperparallel", capacity_factor=CF), mode="tp_sp",
        grad_transform=hook, **kw)
    params = (_params(d, CASES[case][0]) if case in CASES
              else adamw.cast_params(M.init_params(
                  cfg, torch.Generator().manual_seed(0), device="cpu"),
                  torch.float32))
    if mesh.local_rows:
        params = S.own_params(fns.rules, params, mesh)
        state = adamw.init_opt_state(params, fns.rules, mesh)
    else:
        state = adamw.init_opt_state(params)
    batch = SyntheticStream(DataConfig(cfg.vocab, SEQ, BATCH),
                            rules=fns.rules).sharded_batch(0, mesh, "cpu")
    mesh.comm.stats.reset()
    _, _, m = fns.train_step(params, state, batch)
    counts = dict(mesh.comm.stats.counts)
    return float(m["loss"]), seen["g"], params, state, counts, fns.rules


def _attn_inputs(arch):
    cfg = _cfg(arch)
    g = torch.Generator().manual_seed(3)
    p = L.init_attention(g, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.hd, dtype=torch.float32)
    x = torch.randn((BATCH // MESH[0], SEQ, cfg.d_model), generator=g)
    return cfg, p, x


def _projection_flops(run) -> int:
    """The mm FLOPs (the attention's projections; its scores are bmm)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        run()
    return int(sum(n for op, n in fc.get_flop_counts()["Global"].items()
                   if "mm" in str(op) and "bmm" not in str(op)))


def _attention(cfg, p, x):
    return L.attention(p, x, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                       head_dim=cfg.hd, rope_theta=cfg.rope_theta)[0]


def _save_worker(mesh, d):
    from repro_torch.parallel.tp import TensorParallel
    out = {}
    for case in CASES:
        if case.startswith("granite"):
            for remat in (False, True):
                loss, *_, counts, _ = _step(case, mesh, d, remat)
                out[f"{case}/remat{int(remat)}/loss"] = np.float64(loss)
                for k, v in counts.items():
                    out[f"{case}/remat{int(remat)}/count/{k}"] = np.int64(v)
        loss, grads, params, state, _, rules = _step(case, mesh, d)
        out[f"{case}/loss"] = np.float64(loss)
        for i, g in enumerate(grads):
            out[f"{case}/grad/{i}"] = g.numpy()
        for k, tree in (("p", params), ("m", state["m"]), ("v", state["v"]),
                        ("master", state["master"])):
            for i, t in enumerate(_tensors(tree)):
                out[f"{case}/{k}/{i}"] = t.numpy()
        if case in SAVED:
            CK.save(os.path.join(d, f"ckpt_{case}"), 1, DistTrainLayout(
                rules, mesh).tree(params, state), comm=mesh.world)
    for case in ODD_VOCAB:
        loss, grads, *_ = _step(case, mesh, d)
        out[f"{case}/loss"] = np.float64(loss)
        for i, g in enumerate(grads):
            out[f"{case}/grad/{i}"] = g.numpy()
    # One layer's attention on this rank's chunk: its projections' FLOPs.
    cfg, p, x = _attn_inputs(GRANITE)
    rules = _rules("granite")
    own = {k: S.local_block(v, spec, mesh, mesh.coords) for (k, v), spec in
           zip(sorted(p.items()), (rules.param_spec(("attn", k), v.shape)
                                   for k, v in sorted(p.items())))}
    chunk = S.local_block(x, (None, "model", None), mesh, mesh.coords)
    with tensor_parallel_context(TensorParallel(mesh, rules)):
        out["flops/mm"] = np.int64(_projection_flops(
            lambda: _attention(cfg, own, chunk)))
    return out


def _transposes(comm, rank):
    """Each new collective on 2 ranks, forward and backward: (name, this
    rank's output, its input's grad) and the counted collectives."""
    g = torch.Generator().manual_seed(21)
    xs = [torch.randn((2, 6, 4), generator=g) for _ in range(2)]
    ws = [torch.randn((2, 6, 4), generator=g) for _ in range(2)]
    chunk = [torch.randn((2, 3, 4), generator=g) for _ in range(2)]
    out = {}
    comm.stats.reset()
    for name, x, fn, w in (
            ("all_gather", chunk[rank], lambda t: comm.all_gather_dim(t, 1),
             ws[rank]),
            ("reduce_scatter", xs[rank],
             lambda t: comm.reduce_scatter_dim(t, 1), chunk[rank]),
            ("all_reduce_partial", xs[rank],
             lambda t: comm.all_reduce_sum(t, partial_grads=True), ws[rank]),
            ("all_reduce_whole", xs[rank],
             lambda t: comm.all_reduce_sum(t, partial_grads=False), ws[0])):
        x = x.clone().requires_grad_(True)
        y = fn(x)
        (y * w).sum().backward()
        out[f"tr/{name}/y"], out[f"tr/{name}/dx"] = y.detach().numpy(), \
            x.grad.numpy()
    for k, v in comm.stats.counts.items():
        out[f"tr/count/{k}"] = np.int64(v)
    out["tr/bytes"] = np.int64(comm.stats.bytes)
    return out


def _restore_worker(mesh, d):
    out = _transposes(mesh.comm, mesh.comm.rank)
    for case in SAVED:
        arch, kw = CASES[case]
        fns = St.make_steps(_cfg(arch), mesh, opt=OC, ep=EPConfig(
            capacity_factor=CF), mode="tp_sp", **kw)
        params = S.own_params(fns.rules, _params(d, arch), mesh)
        state = adamw.init_opt_state(params, fns.rules, mesh)
        DistTrainLayout(fns.rules, mesh).restore(
            CK.latest_step_dir(os.path.join(d, f"ckpt_{case}")), params,
            state)
        for k, tree in (("p", params), ("m", state["m"]), ("v", state["v"]),
                        ("master", state["master"])):
            for i, t in enumerate(_tensors(tree)):
                out[f"{case}/{k}/{i}"] = t.numpy()
    return out


def _worker(rank, init, d, world, dims, role):
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    torch.set_num_threads(1)
    try:
        mesh = dist_mesh(dims)
        out = (_save_worker if role == "save" else _restore_worker)(mesh, d)
        np.savez(os.path.join(d, f"{role}_rank{rank}.npz"), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _spawn(d, world, dims, role):
    mp.start_processes(_worker, args=(
        f"file://{d / f'init_{role}'}", str(d), world, dims, role),
        nprocs=world, join=True, start_method="spawn")
    ranks = []
    for r in range(world):
        with np.load(d / f"{role}_rank{r}.npz") as z:
            ranks.append(dict(z))
    return ranks


def _jax_params(arch):
    """The reference's init (seed 0) with every norm leaf drawn around its
    neutral value: its layernorm scales start at 0, which would zero dbrx's
    whole stack."""
    import jax
    from repro.configs import get_smoke_config as jget_smoke
    from repro.models import model as JM
    jcfg = jget_smoke(arch)
    rng = np.random.default_rng(7)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            JM.init_params(jcfg, jax.random.PRNGKey(0)))[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        a = np.asarray(leaf, dtype=np.float32)
        name = key.rsplit("/", 1)[-1]
        if name.startswith("ln"):
            base = 1.0 if jcfg.norm == "layernorm" and not name.endswith(
                "_b") else 0.0
            a = (base + 0.1 * rng.standard_normal(a.shape)).astype(
                np.float32)
        out["params/" + key] = a
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX steps (a subprocess) run beside the 4 processes' steps and
    saves, then 2 processes restore and check the transposes."""
    d = tmp_path_factory.mktemp("tp_sp")
    for arch in ARCHS:
        np.savez(d / f"params_{arch}.npz", **_jax_params(arch))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", _JAX, str(d), str(SEQ),
                             str(BATCH)], cwd=str(REPO), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        saved = _spawn(d, WORLD, MESH, "save")
        restored = _spawn(d, 2, (1, 2), "restore")
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert "JAX_OK" in out, err[-3000:]
    with np.load(d / "jax.npz") as z:
        ref = dict(z)
    return d, ref, saved, restored


def _assemble(ranks, case, kind, specs, dims=MESH):
    return [S.assemble([torch.from_numpy(r[f"{case}/{kind}/{i}"])
                        for r in ranks], spec, _shape(dims))
            for i, spec in enumerate(specs)]


@pytest.mark.parametrize("case", list(CASES))
def test_step_loss_and_grads_match_jax_and_the_virtual_ranks(runs, case):
    d, ref, ranks, _ = runs
    arch, _ = CASES[case]
    pspecs, _ = _specs(case)
    losses = [float(r[f"{case}/loss"]) for r in ranks]
    assert len(set(losses)) == 1               # the mean over the ranks
    grads = _assemble(ranks, case, "grad", pspecs)
    want = adamw.tree_leaves(train_params_from_numpy(
        _unflatten(ref, f"{case}/grads"), _cfg(arch), "cpu"))
    np.testing.assert_allclose(losses[0], float(ref[f"{case}/loss"]),
                               rtol=JAX_TOL, atol=JAX_TOL)
    for g, w in zip(grads, want, strict=True):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=JAX_TOL,
                                   atol=JAX_TOL)
    v_loss, v_grads, *_ = _step(case, make_mesh(MESH, "cpu"), d)
    np.testing.assert_allclose(losses[0], v_loss, rtol=VIRTUAL_TOL,
                               atol=VIRTUAL_TOL)
    for g, w in zip(grads, v_grads, strict=True):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=VIRTUAL_TOL,
                                   atol=VIRTUAL_TOL)


@pytest.mark.parametrize("case", list(ODD_VOCAB))
def test_a_vocabulary_the_model_axis_does_not_split(runs, case):
    """A padded vocabulary of 121 rows stays whole on every rank: each
    looks its own tokens up and takes the cross entropy of its sequence
    chunk, the sums added over the ranks. Loss and assembled grads equal
    the virtual ranks' within 1e-6."""
    d, _, ranks, _ = runs
    rules = _rules(case)
    meta = M.init_params(rules.cfg, device="meta")
    pspecs = S.param_specs(rules, meta)
    names = [p for p, _, _ in S.jax_leaves(meta)]
    for name in (("embed",), ("unembed",)):   # whole on every rank
        assert pspecs[names.index(name)] == (None, None)
    losses = [float(r[f"{case}/loss"]) for r in ranks]
    assert len(set(losses)) == 1
    v_loss, v_grads, *_ = _step(case, make_mesh(MESH, "cpu"), d)
    np.testing.assert_allclose(losses[0], v_loss, rtol=VIRTUAL_TOL,
                               atol=VIRTUAL_TOL)
    for g, w in zip(_assemble(ranks, case, "grad", pspecs), v_grads,
                    strict=True):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=VIRTUAL_TOL,
                                   atol=VIRTUAL_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_updates_of_the_same_grads_and_the_blocks_held(runs, case):
    """Both packages' AdamW of JAX's grads agree within 1e-5; the
    processes' update of their blocks, assembled, is bit-equal to the
    port's replicated update of the same grads; each process holds only
    its spec blocks of the params and of m, v and master."""
    d, ref, ranks, _ = runs
    arch, _ = CASES[case]
    cfg = _cfg(arch)
    pspecs, ospecs = _specs(case)
    assert pspecs == ospecs                   # tp_sp: no ZeRO-1

    def replicated(grads):
        params = _params(d, arch)
        state = adamw.init_opt_state(params)
        adamw.apply_updates(params, grads, state, OC)
        return {"p": adamw.tree_leaves(params),
                **{k: adamw.tree_leaves(state[k])
                   for k in ("m", "v", "master")}}

    got = replicated(train_params_from_numpy(
        _unflatten(ref, f"{case}/grads"), cfg, "cpu"))
    jax_state = opt_state_from_numpy(
        {**{k: _unflatten(ref, f"{case}/{k}") for k in ("m", "v", "master")},
         "step": 1}, cfg, "cpu")
    want = {"p": adamw.tree_leaves(train_params_from_numpy(
        _unflatten(ref, f"{case}/p1"), cfg, "cpu")),
        **{k: adamw.tree_leaves(jax_state[k]) for k in ("m", "v", "master")}}
    for k in want:
        for a, b in zip(got[k], want[k], strict=True):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=JAX_TOL,
                                       atol=JAX_TOL, err_msg=k)
    grads = _assemble(ranks, case, "grad", pspecs)
    it = iter(grads)
    same = replicated(adamw.tree_map(lambda _: next(it), _params(d, arch)))
    for k in same:
        for i, (a, b) in enumerate(zip(_assemble(ranks, case, k, pspecs),
                                       same[k], strict=True)):
            assert torch.equal(a, b), (k, i)
    for i, (t, spec) in enumerate(zip(same["p"], pspecs)):
        blk = S.block_shape(t.shape, spec, _shape(MESH))
        for r in ranks:
            for k in ("p", "m", "v", "master"):
                assert r[f"{case}/{k}/{i}"].shape == blk
    split = [S.spec_axes(s) for s in pspecs]
    assert any("model" in a for a in split)
    assert any("data" in a for a in split) == ("fsdp" in case)


@pytest.mark.parametrize("case", SAVED)
def test_checkpoint_restores_at_two_processes_and_one(runs, case):
    """The 4 processes' checkpoint is in the reference's layout: restored
    at mesh 1x2 and in one process, bit-equal to the assembled state, and
    read by the reference's ``restore``."""
    d, ref, saved, restored = runs
    arch, _ = CASES[case]
    step_dir = CK.latest_step_dir(str(d / f"ckpt_{case}"))
    params = _params(d, arch)
    state = adamw.init_opt_state(params)
    JaxTrainLayout.restore(step_dir, params, state)
    assert state["step"] == 1
    one = {"p": adamw.tree_leaves(params),
           **{k: adamw.tree_leaves(state[k]) for k in ("m", "v", "master")}}
    four, _ = _specs(case)
    two, _ = _specs(case, (1, 2))
    for k in ("p", "m", "v", "master"):
        for a, b, c in zip(_assemble(saved, case, k, four),
                           _assemble(restored, case, k, two, (1, 2)),
                           one[k], strict=True):
            assert torch.equal(a, c) and torch.equal(b, c), k
    from repro.checkpoint import ckpt as jckpt
    like = train_params_to_jax(params)
    jtree = {k: v.numpy() for k, v in CK._flatten(like)}
    jstate = opt_state_to_jax(state)
    jstate["step"] = np.int32(jstate["step"])
    (jp, _), _ = jckpt.restore(step_dir, (like, jstate))
    for path, leaf in CK._flatten(jp):
        np.testing.assert_array_equal(np.asarray(leaf), jtree[path])


def test_a_ranks_attention_projections_are_one_mth(runs):
    """A rank projects the group's whole sequence through its heads' column
    blocks alone: its mm FLOPs are 1/M of the one-process layer's, on every
    rank (no rank gathers the weights)."""
    _, _, ranks, _ = runs
    cfg, p, x = _attn_inputs(GRANITE)
    whole = _projection_flops(lambda: _attention(cfg, p, x))
    assert whole > 0
    assert [int(r["flops/mm"]) * MESH[1] for r in ranks] == [whole] * WORLD


def _expected_counts(case, remat):
    """The collectives a rank makes in one step of ``case``, by kind, from
    the layer's structure and the specs (granite's smoke config: 2 layers,
    one cross-entropy chunk)."""
    arch, kw = CASES[case]
    cfg = _cfg(arch)
    seq, fsdp = kw.get("seq_parallel", True), kw.get("fsdp", False)
    m = MESH[1]
    layers, fwd = cfg.n_layers, 1 + int(remat)   # remat runs it twice
    pspecs, _ = _specs(case)
    shape = _shape(MESH)
    n = {k: 0 for k in KINDS}
    n["all-gather"] += 2                  # the tokens, the labels
    if seq:
        n["reduce-scatter"] += 1          # the embedding
        n["all-gather"] += 1              # the final residual
        n["all-gather"] += layers * fwd   # attention's input
        n["reduce-scatter"] += layers * fwd   # attention's output
    else:
        n["all-reduce"] += 1              # the embedding
        n["all-reduce"] += layers * fwd   # attention's output
        # The MoE's output, a layer's last collective: the recompute stops
        # once it has remade what the backward reads, before it.
        n["all-gather"] += layers
    if fsdp:
        n["all-gather"] += 6 * layers * fwd   # wq, wk, wv, wo, w_in, w_down
    n["collective-permute"] += 2 * (m - 1) * layers * fwd   # the ring
    n["all-reduce"] += 2 * 2              # the CE's max and sums, recomputed
    n["all-reduce"] += 1                  # the loss
    n["all-reduce"] += sum(any(shape[a] > 1 and a not in S.spec_axes(s)
                               for a in shape) for s in pspecs)   # grads
    n["all-reduce"] += len({tuple(a for a in shape if a in S.spec_axes(s))
                            for s in pspecs} - {()})   # the clip norm
    return {k: v for k, v in n.items() if v}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("case", [c for c in CASES if c.startswith("gran")])
def test_collectives_a_step_equal_their_formula(runs, case, remat):
    """With and without remat, which runs each layer's forward again (and
    so, under FSDP, gathers its weights twice): the same loss, and the
    collectives of a step by kind equal their formula on every rank."""
    _, _, ranks, _ = runs
    tag = f"{case}/remat{int(remat)}"
    want = _expected_counts(case, remat)
    for r in ranks:
        got = {k.rsplit("/", 1)[1]: int(v) for k, v in r.items()
               if k.startswith(f"{tag}/count/")}
        assert got == want
        np.testing.assert_allclose(float(r[f"{tag}/loss"]),
                                   float(r[f"{case}/remat0/loss"]),
                                   rtol=VIRTUAL_TOL, atol=VIRTUAL_TOL)


@pytest.mark.parametrize("name", ["all_gather", "reduce_scatter",
                                  "all_reduce_partial", "all_reduce_whole"])
def test_each_collective_transposes_to_the_whole_computations_grad(runs,
                                                                   name):
    """On 2 gloo processes each collective's forward and its input's grad
    equal those of the same computation done whole in one process, at
    1e-6: every rank's loss ``sum(y * w_r)`` added (a partial share of the
    cotangent on each rank), or for the all-reduce whose cotangent every
    rank holds whole, one loss ``sum(y * w)``."""
    _, _, _, ranks = runs
    g = torch.Generator().manual_seed(21)
    xs = [torch.randn((2, 6, 4), generator=g) for _ in range(2)]
    ws = [torch.randn((2, 6, 4), generator=g) for _ in range(2)]
    chunk = [torch.randn((2, 3, 4), generator=g) for _ in range(2)]
    if name == "all_gather":
        xx = [c.clone().requires_grad_(True) for c in chunk]
        y = torch.cat(xx, 1)
        ys = [y, y]
        sum((y * w).sum() for w in ws).backward()
    elif name == "reduce_scatter":
        xx = [x.clone().requires_grad_(True) for x in xs]
        whole = xx[0] + xx[1]
        ys = [whole[:, :3], whole[:, 3:]]
        sum((yy * c).sum() for yy, c in zip(ys, chunk)).backward()
    else:
        xx = [x.clone().requires_grad_(True) for x in xs]
        y = xx[0] + xx[1]
        ys = [y, y]
        ws_used = ws if name == "all_reduce_partial" else ws[:1]
        sum((y * w).sum() for w in ws_used).backward()
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r[f"tr/{name}/y"],
                                   ys[rank].detach().numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(r[f"tr/{name}/dx"],
                                   xx[rank].grad.numpy(), rtol=1e-6,
                                   atol=1e-6)
        # One of each kind; the all-reduce twice. A rank sends (M - 1)
        # blocks of the all-gather and of the reduce-scatter's input, and
        # 2 (M - 1) / M of each all-reduced tensor: 96 + 96 + 2 x 192 bytes.
        assert {k.rsplit("/", 1)[1]: int(v) for k, v in r.items()
                if k.startswith("tr/count/")} == {
            "all-gather": 1, "reduce-scatter": 1, "all-reduce": 2}
        assert int(r["tr/bytes"]) == 96 + 96 + 2 * 192


def test_launcher_trains_the_moe_family_in_tp_sp():
    """``train --nproc 4 --mesh 2x2 --mode tp_sp`` trains granite's smoke
    config on the CPU: finite losses, every process's record, and each
    step's transfers timed by kind, the sequence's all-gathers and
    reduce-scatters among them."""
    from repro_torch.launch import train as ttrain
    run = ttrain.main(["--smoke", "--device", "cpu", "--backend", "gloo",
                       "--nproc", "4", "--mesh", "2x2", "--mode", "tp_sp",
                       "--global-batch", "4", "--seq", "16", "--steps", "2"])
    assert len(run.ranks) == WORLD and len(run.metrics_log) == 2
    for m in run.metrics_log:
        assert np.isfinite(m["loss"])
        kinds = {"all-gather", "reduce-scatter", "collective-permute",
                 "all-reduce"}
        assert kinds <= set(m["collectives"]) and kinds <= set(
            m["comm_seconds"])


def test_the_recompute_enters_the_forwards_tensor_parallelism():
    """On the card autograd runs the backward on a thread of its own, where
    the ambient context is unset: each remat layer's recompute must enter
    the forward's tensor parallelism. A stand-in that places nothing
    counts the layers that read it; the backward runs on another thread."""
    import threading
    from repro_torch.parallel.tp import TensorParallel

    class Probe(TensorParallel):
        def __init__(self):
            self.seq, self.m, self.fsdp, self.calls = True, 1, {}, []

        def layer(self, p, part):
            self.calls.append(part)
            return p

        def enter(self, x):
            return x

        def leave(self, y):
            return y

    cfg = _cfg(GRANITE, remat=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    x = torch.randn((2, 8, cfg.d_model), requires_grad=True)
    probe = Probe()
    with tensor_parallel_context(probe):
        y, _ = M._run_stack(cfg, params, x)
    assert probe.calls == ["attn", "moe"] * cfg.n_layers
    t = threading.Thread(target=lambda: y.sum().backward())
    t.start()
    t.join()
    assert probe.calls == ["attn", "moe"] * (2 * cfg.n_layers)
    assert x.grad is not None
