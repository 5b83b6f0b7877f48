"""tp_sp across processes for the dense, ssm, hybrid, vlm and audio
families on the CPU: 4 ``gloo`` processes, one rank each, on mesh 2x2
(``dist_mesh((2, 2))``), in fp32. Cases: llama (GQA, K = 2), qwen2 (QKV
biases), olmo (``nonparam_ln``), gemma (one shared kv head, GeGLU, tied,
``embed_scale``) with and without ``seq_parallel``, mamba2, recurrentgemma
(one super-block and the 2-layer tail) and internvl2 (with patches) with
``fsdp=True``, and hubert (features).

One JAX subprocess (4 forced host devices) runs the reference's
``make_steps(mode="tp_sp")`` on ``make_test_mesh(2, 2)`` for every case;
one spawn of 4 processes runs the port's, each process on its block of the
batch (``sharding.batch_block``). Step 1's loss and the grads assembled
from the ranks' blocks must agree within 1e-5 with JAX and within 1e-6
with the port's one-process run over virtual ranks. Both packages' AdamW is
applied to JAX's grads, and the processes' update, assembled, must be
bit-equal to the port's replicated one; each process holds its spec blocks
alone. The same spawn holds each new exchange (the GLU's pairing, the
shared kv heads' gather, the SSM's columns, conv and norm, the RG-LRU's
branch) to the grads of the same module computed whole, and counts each
case's collectives and bytes a step with and without remat, which must
equal their formula.
"""

import dataclasses
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import (opt_state_from_numpy,  # noqa: E402
                                 train_params_from_numpy)
from repro_torch.data.pipeline import DataConfig, SyntheticStream  # noqa
from repro_torch.launch import steps as St  # noqa: E402
from repro_torch.launch.mesh import dist_mesh, make_mesh  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.rglru import init_rglru, rglru_block  # noqa: E402
from repro_torch.models.ssm import init_ssm, ssm_forward  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402
from repro_torch.parallel import tp as TP  # noqa: E402
from repro_torch.parallel.ctx import tensor_parallel_context  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
# case -> (arch, make_steps keywords)
CASES = {"llama": ("llama3.2-3b", {}),
         "qwen2": ("qwen2-1.5b", {}),
         "olmo": ("olmo-1b", {}),
         "gemma": ("gemma-2b", {}),
         "gemma_noseq": ("gemma-2b", {"seq_parallel": False}),
         "mamba2": ("mamba2-1.3b", {}),
         "recurrentgemma_fsdp": ("recurrentgemma-2b", {"fsdp": True}),
         "internvl2_fsdp": ("internvl2-26b", {"fsdp": True}),
         "hubert": ("hubert-xlarge", {})}
ARCHS = sorted({a for a, _ in CASES.values()})
MESH, WORLD = (2, 2), 4
SEQ, BATCH = 16, 4
JAX_TOL, VIRTUAL_TOL = 1e-5, 1e-6
OC = adamw.OptConfig(lr=3e-3, warmup_steps=2, total_steps=10)
# Held to the virtual ranks alone: internvl2 with a padded vocabulary of
# 121 rows, which the model axis does not split (the patches go before the
# group's tokens looked up whole, the rank keeping its chunk).
ODD_VOCAB = {"internvl2_v121": ("internvl2-26b", {})}
# The exchanges held to the whole module: name -> (arch, the layer part,
# the mesh); at M = 4 the GLU's blocks are all-gathered, not swapped.
MODULES = {"attention_shared_kv": ("gemma-2b", "attn", MESH),
           "glu_mlp": ("gemma-2b", "mlp", MESH),
           "glu_mlp_m4": ("gemma-2b", "mlp", (1, 4)),
           "ssm": ("mamba2-1.3b", "ssm", MESH),
           "rglru": ("recurrentgemma-2b", "rglru", MESH)}


def _cfg(arch, remat=False):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               remat=remat)


def _case(case, remat=False):
    """(config, make_steps keywords) of a case."""
    arch, kw = {**CASES, **ODD_VOCAB}[case]
    cfg = _cfg(arch, remat)
    if case in ODD_VOCAB:
        cfg = dataclasses.replace(cfg, vocab=121, vocab_pad=1)
    return cfg, kw


def _shape(dims=MESH):
    return dict(zip(("data", "model"), dims))


def _rules(case):
    cfg, kw = _case(case)
    mesh = types.SimpleNamespace(shape=_shape(), axis_names=("data", "model"))
    return S.ShardingRules(cfg, mesh, mode="tp_sp", fsdp=kw.get("fsdp"))


def _specs(case):
    rules = _rules(case)
    return S.param_specs(rules, M.init_params(rules.cfg, device="meta"))


def _unflatten(flat: dict, prefix: str) -> dict:
    """A tree from ``prefix/...`` keys; a node whose keys are all indices
    becomes a list (the hybrid ``super`` and ``tail``)."""
    out: dict = {}
    for k, v in flat.items():
        if not k.startswith(prefix + "/"):
            continue
        node, parts = out, k[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[k]) for k in sorted(node, key=int)]
        return {k: lists(v) for k, v in node.items()}
    return lists(out)


def _tensors(tree) -> list:
    return [t.detach().clone() for t in adamw.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _params(d, arch):
    """The reference's initial params (written by the fixture) as the
    port's."""
    with np.load(os.path.join(d, f"params_{arch}.npz")) as z:
        return train_params_from_numpy(_unflatten(dict(z), "params"),
                                       _cfg(arch), "cpu")


def _batch(d, arch):
    """The global batch of ``arch`` (written by the fixture)."""
    with np.load(os.path.join(d, f"batch_{arch}.npz")) as z:
        return {k: torch.from_numpy(v).to(
            torch.long if k in ("tokens", "labels") else torch.float32)
            for k, v in z.items()}


def _batch_np(arch):
    """Tokens and labels from the synthetic stream; a vlm's patches, an
    audio encoder's features and frame labels from a numpy generator."""
    cfg = _cfg(arch)
    rng = np.random.default_rng(13)
    if cfg.family == "audio":
        return {"features": rng.standard_normal(
                    (BATCH, SEQ, cfg.feat_in)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab, (BATCH, SEQ)
                                       ).astype(np.int32)}
    out = SyntheticStream(DataConfig(cfg.vocab, SEQ, BATCH)
                          ).global_batch_np(0)
    if cfg.family == "vlm":
        out["patches"] = (0.5 * rng.standard_normal(
            (BATCH, cfg.n_patches, cfg.d_model))).astype(np.float32)
    return out


def _jax_params(arch):
    """The reference's init (seed 0) with every norm leaf drawn around its
    neutral value: its layernorm scales start at 0, which would zero
    hubert's whole stack (ROADMAP Queue 3 · 5)."""
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


_JAX = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.launch import steps as St
from repro.launch.mesh import make_test_mesh
from repro.models import model as M
from repro.optim import adamw

d = sys.argv[1]
CASES = json.loads(sys.argv[2])
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
    with np.load(os.path.join(d, f"batch_{arch}.npz")) as z:
        b = {k: jnp.asarray(v) for k, v in z.items()}
    s0 = adamw.init_opt_state(p0)
    box = {}
    def hook(g, box=box):
        box["g"] = g
        return g
    fns = St.make_steps(cfg, mesh, opt=oc, mode="tp_sp",
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
    took, params, state, step counts, bytes a rank)."""
    arch = {**CASES, **ODD_VOCAB}[case][0]
    cfg, kw = _case(case, remat)
    seen = {}

    def hook(g):
        seen["g"] = _tensors(g)
        return g
    fns = St.make_steps(cfg, mesh, opt=OC, mode="tp_sp", grad_transform=hook,
                        **kw)
    params = (_params(d, arch) if case in CASES else adamw.cast_params(
        M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"),
        torch.float32))
    batch = _batch(d, arch)
    if case in ODD_VOCAB:
        for k in ("tokens", "labels"):
            batch[k] = batch[k] % cfg.vocab
    if mesh.local_rows:
        params = S.own_params(fns.rules, params, mesh)
        state = adamw.init_opt_state(params, fns.rules, mesh)
        batch = S.batch_block(fns.rules, batch, mesh)
    else:
        state = adamw.init_opt_state(params)
    mesh.comm.stats.reset()
    _, _, m = fns.train_step(params, state, batch)
    stats = mesh.comm.stats
    return (float(m["loss"]), seen["g"], params, state, dict(stats.counts),
            stats.bytes)


def _module_inputs(name):
    """A module's whole params (every leaf moved off its init by a draw,
    so no grad is trivially 0), input and output weights [2, SEQ, d]."""
    arch, part, _ = MODULES[name]
    cfg = _cfg(arch)
    g = torch.Generator().manual_seed(5)
    d = cfg.d_model
    if part == "attn":
        p = L.init_attention(g, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                             cfg.qkv_bias)
    elif part == "mlp":
        p = L.init_mlp(g, d, cfg.d_ff, cfg.act)
    elif part == "ssm":
        p = init_ssm(g, d, cfg.ssm)
    else:
        p = init_rglru(g, d, cfg.lru_width or d)
    p = {k: v + 0.05 * torch.randn(v.shape, generator=g)
         for k, v in sorted(p.items())}
    x = torch.randn((2, SEQ, d), generator=g)
    w = torch.randn((2, SEQ, d), generator=g)
    return cfg, part, p, x, w


def _module(cfg, part, p, x):
    if part == "attn":
        return L.attention(p, x, n_heads=cfg.n_heads,
                           n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                           rope_theta=cfg.rope_theta)[0]
    if part == "mlp":
        return L.mlp(p, x, cfg.act)
    if part == "ssm":
        return ssm_forward(p, x, cfg.ssm)[0]
    return rglru_block(p, x)[0]


def _module_checks(meshes):
    """Each exchange's module on the rank's blocks and sequence chunk, its
    loss ``sum(y * w)`` over the chunk (the ranks' losses add to the whole
    one): the output chunk, the input's grad and each param block's grad
    (a replicated leaf's partial grads summed over ``model``)."""
    out = {}
    for name, (_, _, dims) in MODULES.items():
        mesh = meshes[dims]
        cfg, part, p, x, w = _module_inputs(name)
        rules = S.ShardingRules(cfg, mesh, mode="tp_sp", fsdp=False)
        specs = {k: rules.param_spec((part, k), v.shape)
                 for k, v in p.items()}
        own = {k: S.local_block(v, specs[k], mesh, mesh.coords).clone()
               .requires_grad_(True) for k, v in p.items()}
        chunk = (None, "model", None)
        xc = S.local_block(x, chunk, mesh, mesh.coords).clone() \
            .requires_grad_(True)
        tp = TP.TensorParallel(mesh, rules)
        with tensor_parallel_context(tp):
            y = _module(cfg, part, tp.layer(own, part), xc)
        (y * S.local_block(w, chunk, mesh, mesh.coords)).sum().backward()
        out[f"mod/{name}/y"] = y.detach().numpy()
        out[f"mod/{name}/dx"] = xc.grad.numpy()
        for k, v in own.items():
            grad = v.grad
            if "model" not in S.spec_axes(specs[k]):
                grad = mesh.comm.all_reduce(grad)
            out[f"mod/{name}/d/{k}"] = grad.numpy()
    return out


def _worker(rank, init, d):
    dist.init_process_group("gloo", init_method=init, world_size=WORLD,
                            rank=rank)
    torch.set_num_threads(1)
    try:
        mesh = dist_mesh(MESH)
        out = _module_checks({MESH: mesh, (1, 4): dist_mesh((1, 4))})
        for case in ODD_VOCAB:
            loss, grads, *_ = _step(case, mesh, d)
            out[f"{case}/remat0/loss"] = np.float64(loss)
            for i, g in enumerate(grads):
                out[f"{case}/grad/{i}"] = g.numpy()
        for case in CASES:
            for remat in (False, True):
                tag = f"{case}/remat{int(remat)}"
                loss, grads, params, state, counts, nbytes = _step(
                    case, mesh, d, remat)
                out[f"{tag}/loss"] = np.float64(loss)
                out[f"{tag}/bytes"] = np.int64(nbytes)
                for k, v in counts.items():
                    out[f"{tag}/count/{k}"] = np.int64(v)
                if remat:
                    continue
                for i, g in enumerate(grads):
                    out[f"{case}/grad/{i}"] = g.numpy()
                for k, tree in (("p", params), ("m", state["m"]),
                                ("v", state["v"]),
                                ("master", state["master"])):
                    for i, t in enumerate(_tensors(tree)):
                        out[f"{case}/{k}/{i}"] = t.numpy()
        np.savez(os.path.join(d, f"rank{rank}.npz"), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX steps (a subprocess) run beside the 4 processes' steps."""
    import json
    d = tmp_path_factory.mktemp("tp_sp_families")
    for arch in ARCHS:
        np.savez(d / f"params_{arch}.npz", **_jax_params(arch))
        np.savez(d / f"batch_{arch}.npz", **_batch_np(arch))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", _JAX, str(d),
                             json.dumps(CASES)], cwd=str(REPO), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        mp.start_processes(_worker, args=(f"file://{d / 'init'}", str(d)),
                           nprocs=WORLD, join=True, start_method="spawn")
        ranks = []
        for r in range(WORLD):
            with np.load(d / f"rank{r}.npz") as z:
                ranks.append(dict(z))
        out, err = proc.communicate(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert "JAX_OK" in out, err[-3000:]
    with np.load(d / "jax.npz") as z:
        ref = dict(z)
    return d, ref, ranks


def _assemble(ranks, case, kind, specs):
    return [S.assemble([torch.from_numpy(r[f"{case}/{kind}/{i}"])
                        for r in ranks], spec, _shape())
            for i, spec in enumerate(specs)]


@pytest.mark.parametrize("case", list(CASES))
def test_step_loss_and_grads_match_jax_and_the_virtual_ranks(runs, case):
    d, ref, ranks = runs
    arch, _ = CASES[case]
    losses = [float(r[f"{case}/remat0/loss"]) for r in ranks]
    assert len(set(losses)) == 1               # the mean over the ranks
    grads = _assemble(ranks, case, "grad", _specs(case))
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
def test_patches_with_a_vocabulary_the_model_axis_does_not_split(runs, case):
    """A vlm step whose padded vocabulary (121 rows) stays whole on every
    rank: each looks up its group's tokens whole, puts the patches before
    them and keeps its chunk; the cross entropy runs on its chunk of the
    token region. Loss and assembled grads equal the virtual ranks' within
    1e-6."""
    d, _, ranks = runs
    specs = _specs(case)
    names = [p for p, _, _ in S.jax_leaves(M.init_params(
        _case(case)[0], device="meta"))]
    for name in (("embed",), ("unembed",)):     # whole on every rank
        assert specs[names.index(name)] == (None, None)
    losses = [float(r[f"{case}/remat0/loss"]) for r in ranks]
    assert len(set(losses)) == 1
    v_loss, v_grads, *_ = _step(case, make_mesh(MESH, "cpu"), d)
    np.testing.assert_allclose(losses[0], v_loss, rtol=VIRTUAL_TOL,
                               atol=VIRTUAL_TOL)
    for g, w in zip(_assemble(ranks, case, "grad", specs), v_grads,
                    strict=True):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=VIRTUAL_TOL,
                                   atol=VIRTUAL_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_updates_of_the_same_grads_and_the_blocks_held(runs, case):
    """Both packages' AdamW of JAX's grads agree within 1e-5; the
    processes' update of their blocks, assembled, is bit-equal to the
    port's replicated update of the same grads; each process holds only
    its spec blocks of the params and of m, v and master."""
    d, ref, ranks = runs
    arch, kw = CASES[case]
    cfg = _cfg(arch)
    pspecs = _specs(case)

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
        blk = S.block_shape(t.shape, spec, _shape())
        for r in ranks:
            for k in ("p", "m", "v", "master"):
                assert r[f"{case}/{k}/{i}"].shape == blk
    split = [S.spec_axes(s) for s in pspecs]
    assert any("model" in a for a in split)
    assert any("data" in a for a in split) == kw.get("fsdp", False)


@pytest.mark.parametrize("name", list(MODULES))
def test_each_exchange_holds_the_whole_modules_grads(runs, name):
    """The GLU's pairing (an all-to-all at M = 2, an all-gather and a
    slice at M = 4), the shared kv head's gathered projections, the SSM's gathered columns, conv and summed
    squares, and the RG-LRU's gathered branch: each rank's output chunk,
    its input chunk's grad and each param block's grad equal those of the
    module computed whole in one process, within 1e-6 of the whole
    tensor's largest value (a grad summed over 2 x 16 positions of
    O(1) terms reaches ~10)."""
    _, _, ranks = runs
    cfg, part, p, x, w = _module_inputs(name)
    p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    x = x.clone().requires_grad_(True)
    y = _module(cfg, part, p, x)
    (y * w).sum().backward()
    shape = _shape(MODULES[name][2])
    mesh = types.SimpleNamespace(shape=shape, axis_names=("data", "model"))
    rules = S.ShardingRules(cfg, mesh, mode="tp_sp", fsdp=False)
    chunk = (None, "model", None)
    for rank, r in enumerate(ranks):
        coords = S.rank_coords(shape, rank)
        for key, want in (("y", y.detach()), ("dx", x.grad)):
            np.testing.assert_allclose(
                r[f"mod/{name}/{key}"],
                S.local_block(want, chunk, shape, coords).numpy(),
                rtol=0, atol=VIRTUAL_TOL * float(want.abs().max()),
                err_msg=key)
        for k, v in p.items():
            spec = rules.param_spec((part, k), v.shape)
            np.testing.assert_allclose(
                r[f"mod/{name}/d/{k}"],
                S.local_block(v.grad, spec, shape, coords).numpy(),
                rtol=0, atol=VIRTUAL_TOL * float(v.grad.abs().max()),
                err_msg=k)


def _expected(case, remat):
    """The collectives a rank makes in one step of ``case`` and the bytes
    it sends, by kind, from each block's structure and the specs: a list
    of (kind, bytes). Under remat each checkpointed unit (a layer; a
    hybrid super-block) runs again but for its last collective, the
    output's, after which the recompute has nothing left to remake."""
    arch, kw = CASES[case]
    cfg = _cfg(arch)
    seq, fsdp = kw.get("seq_parallel", True), kw.get("fsdp", False)
    Dn, m = MESH
    P = cfg.n_patches if cfg.family == "vlm" else 0
    # T: the residual's positions (a vlm's patches and tokens).
    b, T, d, e = BATCH // Dn, P + SEQ, cfg.d_model, 4
    c = SEQ // m
    rules = _rules(case)
    meta = M.init_params(cfg, device="meta")
    layer = {}          # (part, name) -> (per-layer shape, spec)
    for path, shape, stacked in S.jax_leaves(meta):
        if len(path) >= 2 and path[-2] in TP.PARTS:
            spec = rules.param_spec(path, shape)
            layer[tuple(path[-2:])] = ((shape[1:], spec[1:]) if stacked
                                       else (shape, spec))
    whole = {("ssm", "conv_w"), ("ssm", "conv_b")}
    if cfg.n_kv_heads % m:
        whole |= {("attn", k) for k in ("wk", "wv", "bk", "bv")}

    def ag(n, ranks=m):
        return [("all-gather", (ranks - 1) * n)]

    def ar(n, ranks=m):
        return [("all-reduce", 2 * (ranks - 1) * n // ranks)]

    def enter():
        return ag(b * T // m * d * e) if seq else []

    def leave():
        n = b * T * d * e
        return [("reduce-scatter", (m - 1) * n // m)] if seq else ar(n)

    def gathers(part):
        out = []
        for (pt, name), (shape, spec) in sorted(layer.items()):
            if pt != part:
                continue
            axes = S.spec_axes(spec)
            n = math.prod(shape) * e // math.prod(
                _shape()[a] for a in axes)
            if fsdp and "data" in axes and Dn > 1:   # one rank: no gather
                out += ag(n, Dn)
                n *= Dn
            if (pt, name) in whole and "model" in axes:
                out += ag(n)
        return out

    def attn():
        return gathers("attn") + enter() + leave()

    def mlp():
        out = gathers("mlp") + enter()
        if cfg.act in ("swiglu", "geglu"):      # the GLU's pairing
            n = b * T * cfg.d_ff // m * e       # a gate or up block
            out += ([("all-to-all", (m - 1) * n)] if m == 2
                    else ag(2 * n))             # M > 2: gathered, sliced
        return out + leave()

    def ssm():
        sc = cfg.ssm
        d_in, H = sc.expand * d, sc.n_heads(d)
        zxbcdt = 2 * d_in + 2 * sc.d_state + H
        return (gathers("ssm") + enter()
                + ag(b * T * zxbcdt // m * e)            # the projection
                + ar(b * T * e)                          # the norm's squares
                + leave())

    def rglru():
        w = cfg.lru_width or d
        return (gathers("rglru") + enter() + ag(b * T * w // m * e)
                + leave() + mlp())

    blocks = {"attn": lambda: attn() + mlp(), "local_attn":
              lambda: attn() + mlp(), "ssm": ssm, "rglru": rglru}

    def unit(recs):
        return recs + recs[:-1] if remat else recs

    types_ = cfg.layer_types()
    recs = []
    if cfg.family == "audio":
        recs += [] if seq else ag(b * c * cfg.feat_in * e)
    else:
        recs += ag(b * c * 8)                            # the tokens
        recs += leave()                                  # the embedding
    if cfg.family == "hybrid":
        pat = len(cfg.hybrid_pattern)
        n_super = cfg.n_layers // pat
        for _ in range(n_super):
            recs += unit(sum((blocks[t]() for t in cfg.hybrid_pattern), []))
        for t in types_[n_super * pat:]:
            recs += blocks[t]()
    else:
        for t in types_:
            recs += unit(blocks[t]())
    recs += enter()         # the final residual (a vlm's before the cut)
    recs += ag(b * c * 8)                                # the labels
    recs += 2 * (ar(b * SEQ * 4) + ar(2 * b * SEQ * 4))  # the CE, recomputed
    recs += ar(4, Dn * m)                                # the loss
    shape = _shape()
    specs = _specs(case)
    for (_, shp, _), spec in zip(S.jax_leaves(meta), specs):
        axes = S.spec_axes(spec)
        n = math.prod(shp[1:] if len(shp) > len(spec) else shp) * e // \
            math.prod(shape[a] for a in axes)
        rest = [a for a in shape if a not in axes and shape[a] > 1]
        if rest:                                         # the grads
            recs += ar(n, math.prod(shape[a] for a in rest))
    groups = {}
    for spec in specs:
        axes = tuple(a for a in shape if a in S.spec_axes(spec))
        if axes:
            groups[axes] = groups.get(axes, 0) + 1
    for axes, k in groups.items():                       # the clip norm
        recs += ar(8 * k, math.prod(shape[a] for a in axes))
    return recs


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_collectives_a_step_equal_their_formula(runs, case, remat):
    """With and without remat, which runs each checkpointed unit again:
    the same loss, and on every rank the collectives of a step by kind and
    the bytes it sends equal their formula."""
    _, _, ranks = runs
    tag = f"{case}/remat{int(remat)}"
    recs = _expected(case, remat)
    want = {}
    for kind, _ in recs:
        want[kind] = want.get(kind, 0) + 1
    for r in ranks:
        got = {k.rsplit("/", 1)[1]: int(v) for k, v in r.items()
               if k.startswith(f"{tag}/count/")}
        assert got == want
        assert int(r[f"{tag}/bytes"]) == sum(n for _, n in recs)
        np.testing.assert_allclose(float(r[f"{tag}/loss"]),
                                   float(r[f"{case}/remat0/loss"]),
                                   rtol=VIRTUAL_TOL, atol=VIRTUAL_TOL)


def test_batch_block_takes_every_entrys_block():
    """``batch_block`` cuts each entry by ``batch_spec``: tokens, labels and
    features over the data rows and the model's sequence chunks, a vlm's
    patches over the data rows alone."""
    rules = _rules("internvl2_fsdp")
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.arange(BATCH * SEQ).reshape(BATCH, SEQ),
             "features": torch.randn((BATCH, SEQ, 3), generator=g),
             "patches": torch.randn((BATCH, 5, 3), generator=g)}
    for rank in range(WORLD):
        coords = S.rank_coords(_shape(), rank)
        mesh = types.SimpleNamespace(shape=_shape(), coords=coords)
        got = S.batch_block(rules, batch, mesh)
        rows = slice(coords["data"] * 2, coords["data"] * 2 + 2)
        cols = slice(coords["model"] * 8, coords["model"] * 8 + 8)
        assert torch.equal(got["tokens"], batch["tokens"][rows, cols])
        assert torch.equal(got["features"], batch["features"][rows, cols])
        assert torch.equal(got["patches"], batch["patches"][rows])


@pytest.mark.parametrize("arch,what", [("llama3.2-3b", "n_heads"),
                                       ("mamba2-1.3b", "SSM's heads"),
                                       ("gemma-2b", "d_ff")])
def test_tensor_parallel_refuses_what_does_not_split(arch, what):
    """Channel blocks that the model axis does not split raise
    ``ValueError`` when ``TensorParallel`` is built; query heads that do
    not split are taken, ⌈H/M⌉ on the first H mod M ranks (6 heads at
    M = 4: 2, 2, 1, 1), as is a kv head count that does not split (gemma's
    one, at M = 2)."""
    cfg = _cfg(arch)
    if what == "n_heads":
        cfg, m = dataclasses.replace(cfg, n_heads=6, n_kv_heads=6), 4
    elif what == "d_ff":
        cfg, m = dataclasses.replace(cfg, d_ff=130), 4
    else:
        m = 3                          # 8 heads
    mesh = types.SimpleNamespace(shape={"data": 1, "model": m},
                                 axis_names=("data", "model"),
                                 comm=types.SimpleNamespace(ep=m, rank=0))
    rules = S.ShardingRules(cfg, mesh, mode="tp_sp", fsdp=False)
    if what == "n_heads":
        spans = []
        for r in range(m):
            mesh.comm.rank = r
            spans.append(TP.TensorParallel(mesh, rules).head_range(6))
        assert spans == [(0, 2), (2, 4), (4, 5), (5, 6)]
        return
    with pytest.raises(ValueError, match=what):
        TP.TensorParallel(mesh, rules)
    if arch == "gemma-2b":
        ok = dataclasses.replace(_cfg(arch), n_heads=4)   # K = 1, M = 2
        mesh2 = types.SimpleNamespace(
            shape=_shape(), axis_names=("data", "model"),
            comm=types.SimpleNamespace(ep=2, rank=1))
        tp = TP.TensorParallel(mesh2, S.ShardingRules(
            ok, mesh2, mode="tp_sp", fsdp=False))
        assert tp.kv_select(4, 1).tolist() == [0, 0]
        assert set(tp.whole) == {("attn", "wk"), ("attn", "wv")}


@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-1.3b",
                                  "recurrentgemma-2b", "internvl2-26b"])
def test_launcher_trains_every_family_in_tp_sp(arch):
    """``train --nproc 4 --mesh 2x2 --mode tp_sp`` trains the dense, ssm,
    hybrid and vlm families' smoke configs on the CPU (token batches, as
    the launcher feeds them): finite losses, every process's record, the
    sequence's all-gathers and reduce-scatters among each step's
    collectives."""
    from repro_torch.launch import train as ttrain
    run = ttrain.main(["--smoke", "--device", "cpu", "--backend", "gloo",
                       "--nproc", "4", "--mesh", "2x2", "--mode", "tp_sp",
                       "--global-batch", "4", "--seq", "16", "--steps", "2",
                       "--arch", arch])
    assert len(run.ranks) == WORLD and len(run.metrics_log) == 2
    for m in run.metrics_log:
        assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
        assert {"all-gather", "reduce-scatter"} <= set(m["collectives"])


def test_the_recompute_enters_the_hybrid_stacks_tensor_parallelism():
    """The hybrid stack's super-blocks run under remat through
    ``model._remat``: autograd's recompute, on a thread of its own, enters
    the forward's tensor parallelism. A stand-in that places nothing counts
    the parts that read it: the super-block's 6 again in the backward, the
    tail's 4 (not checkpointed, as JAX's unrolled tail) once."""
    import threading

    class Probe(TP.TensorParallel):
        def __init__(self):
            self.seq, self.m, self.rank, self.calls = True, 1, 0, []

        def layer(self, p, part):
            self.calls.append(part)
            return p

        def enter(self, x):
            return x

        def leave(self, y):
            return y

    cfg = _cfg("recurrentgemma-2b", remat=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    x = torch.randn((2, 8, cfg.d_model), requires_grad=True)
    probe = Probe()
    with tensor_parallel_context(probe):
        y, _ = M._run_stack(cfg, params, x)
    sup = ["rglru", "mlp", "rglru", "mlp", "attn", "mlp"]
    tail = ["rglru", "mlp", "rglru", "mlp"]
    assert probe.calls == sup + tail
    t = threading.Thread(target=lambda: y.sum().backward())
    t.start()
    t.join()
    assert probe.calls == sup + tail + sup
    assert x.grad is not None
