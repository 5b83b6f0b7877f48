"""Serving across a process mesh on the CPU: 4 ``gloo`` processes, one rank
each, on mesh 2x2 (``dist_mesh((2, 2))``), in fp32. Each runs
``make_steps(...).prefill_step`` of a 16-token prompt into its blocks of
the cache, then 4 teacher-forced ``decode_step``s (recurrentgemma's 16-slot
ring wraps; internvl2's patches take the first slots; hubert's prefill is
its forward). Cases: tp_sp for granite (EP), llama3.2 (GQA), gemma (one kv
head), mamba2, recurrentgemma, internvl2 and hubert; zero1 and ep_dp for
granite and llama at 2 rows (their rows repeat over ``model``).

Two JAX subprocesses (4 forced host devices) run the reference's
``make_steps`` with ``jit_prefill_step``/``jit_decode_step`` on
``make_test_mesh(2, 2)`` (its cache placed by ``rules.cache_shardings``
before the first decode step) from the same params and tokens. Every
rank's logits, whole on each rank, must agree within 1e-5 with JAX's and
with the port's one-process run (virtual ranks), and every rank's cache,
after the prefill and after the last step, with its ``cache_spec`` block
of JAX's (``convert.cache_from_numpy``, ``sharding.own_cache``). The
counting mesh's forward collectives and bytes must equal the processes'
records, and both packages refuse 4 rows on 2x2 in zero1, where the cache
spec names ``model`` twice.
"""

import dataclasses
import json
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

import test_torch_tp_sp_families as TPF  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import (cache_from_numpy,  # noqa: E402
                                 cache_to_numpy, params_from_numpy)
from repro_torch.launch import steps as St  # noqa: E402
from repro_torch.launch.mesh import (counting_mesh, dist_mesh,  # noqa: E402
                                     make_mesh)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402
from repro_torch.parallel.ep import EPConfig  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
# case -> (arch, mode, rows)
CASES = {"granite": ("granite-moe-3b-a800m", "tp_sp", 4),
         "llama": ("llama3.2-3b", "tp_sp", 4),
         "gemma": ("gemma-2b", "tp_sp", 4),
         "mamba2": ("mamba2-1.3b", "tp_sp", 4),
         "recurrentgemma": ("recurrentgemma-2b", "tp_sp", 4),
         "internvl2": ("internvl2-26b", "tp_sp", 4),
         "hubert": ("hubert-xlarge", "tp_sp", 4),
         "granite_zero1": ("granite-moe-3b-a800m", "zero1", 2),
         "granite_ep_dp": ("granite-moe-3b-a800m", "ep_dp", 2),
         "llama_zero1": ("llama3.2-3b", "zero1", 2),
         "llama_ep_dp": ("llama3.2-3b", "ep_dp", 2)}
# 4 rows on 2x2 in zero1: rows over (data, model), the slots over model.
DUPLICATE = ("llama3.2-3b", "zero1", 4)
ARCHS = sorted({a for a, _, _ in CASES.values()})
MESH, WORLD = (2, 2), 4
PROMPT, NEW = 16, 4
TOL = 1e-5


def _cfg(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               remat=False)


def _ep(cfg):
    return EPConfig() if cfg.family == "moe" else None


def _max_len(cfg):
    """The prompt, a vlm's patches and the new tokens."""
    return PROMPT + NEW + (cfg.n_patches if cfg.family == "vlm" else 0)


def _inputs_np(case):
    """The prompt batch (tokens, a vlm's patches, an audio encoder's
    frames) and the new tokens [rows, NEW, 1] of a case."""
    arch, _, rows = CASES.get(case, DUPLICATE)
    cfg = _cfg(arch)
    rng = np.random.default_rng(sorted(CASES).index(case)
                                if case in CASES else 99)
    if cfg.family == "audio":
        return {"features": rng.standard_normal(
            (rows, PROMPT, cfg.feat_in)).astype(np.float32)}
    out = {"tokens": rng.integers(0, cfg.vocab, (rows, PROMPT)).astype(
               np.int32),
           "new": rng.integers(0, cfg.vocab, (rows, NEW, 1)).astype(
               np.int32)}
    if cfg.family == "vlm":
        out["patches"] = (0.5 * rng.standard_normal(
            (rows, cfg.n_patches, cfg.d_model))).astype(np.float32)
    return out


def _inputs(d, case):
    """(the prompt batch, the new tokens or None) as the port's tensors."""
    with np.load(os.path.join(d, f"serve_{case}.npz")) as z:
        b = {k: torch.from_numpy(v).to(
            torch.long if v.dtype == np.int32 else torch.float32)
            for k, v in z.items()}
    return b, b.pop("new", None)


def _params(d, arch):
    with np.load(os.path.join(d, f"params_{arch}.npz")) as z:
        return params_from_numpy(TPF._unflatten(dict(z), "params"),
                                 _cfg(arch), "cpu")


_JAX = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.launch import steps as St
from repro.launch.mesh import make_test_mesh
from repro.models import model as M
from repro.parallel.ep import EPConfig

d = sys.argv[1]
CASES = json.loads(sys.argv[2])
mesh = make_test_mesh(2, 2)
out = {}

def key(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)

def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[f"{prefix}/{key(path)}"] = np.asarray(leaf)

for case, (arch, mode, max_len, new_steps) in CASES.items():
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              remat=False)
    init = M.init_params(cfg, jax.random.PRNGKey(0))
    with np.load(os.path.join(d, f"params_{arch}.npz")) as z:
        p0 = jax.tree_util.tree_map_with_path(
            lambda path, _: jnp.asarray(z["params/" + key(path)]), init)
    with np.load(os.path.join(d, f"serve_{case}.npz")) as z:
        b = {k: jnp.asarray(v) for k, v in z.items() if k != "new"}
        new = z["new"] if "new" in z else None
    fns = St.make_steps(cfg, mesh, mode=mode,
                        ep=EPConfig() if cfg.family == "moe" else None)
    try:
        with jax.set_mesh(mesh):
            if case == "duplicate":     # placing its cache raises
                rows = new.shape[0]
                St.jit_decode_step(fns, p0, new[:, 0], jax.eval_shape(
                    lambda: M.init_cache(cfg, rows, max_len)))
            logits, cache = St.jit_prefill_step(fns, p0, b, max_len)(p0, b)
            out[f"{case}/logits/0"] = np.asarray(logits)
            if cache is not None:
                put(f"{case}/cache0", cache)
                cache = jax.device_put(cache,
                                       fns.rules.cache_shardings(cache))
                dec = St.jit_decode_step(fns, p0, new[:, 0], cache)
                for i in range(new_steps):
                    logits, cache = dec(p0, new[:, i], cache)
                    out[f"{case}/logits/{i + 1}"] = np.asarray(logits)
                put(f"{case}/cache1", cache)
    except Exception as e:
        out[f"{case}/error"] = np.asarray(f"{type(e).__name__}: {e}")
np.savez(os.path.join(d, sys.argv[3]), **out)
print("JAX_OK")
"""
# The JAX cases run in two subprocesses side by side, these in the first:
# granite's and recurrentgemma's steps compile longest, about half.
JAX_FIRST = {"granite", "recurrentgemma", "duplicate"}


def _flat(cache) -> list:
    return [t.detach().clone() for t in adamw.tree_leaves(cache)]


def _serve(case, mesh, d):
    """``case``'s prefill and decode steps on ``mesh`` (a process mesh, or
    virtual ranks): (each step's logits, the cache after the prefill and
    after the last step, each as its leaves, and the forward collectives
    and bytes of the prefill and of the last decode step)."""
    arch, mode, rows = CASES[case]
    cfg = _cfg(arch)
    fns = St.make_steps(cfg, mesh, mode=mode, ep=_ep(cfg), global_batch=rows)
    params, (batch, new) = _params(d, arch), _inputs(d, case)
    if mesh.local_rows:
        params = S.own_params(fns.rules, params, mesh)
        batch = S.batch_block(fns.rules, batch, mesh)
        if new is not None:
            new = S.batch_block(fns.rules, {"new": new}, mesh)["new"]
    stats = mesh.comm.stats
    stats.reset()
    logits, cache = fns.prefill_step(params, batch, _max_len(cfg))
    out = {"logits": [logits], "records": [(dict(stats.counts),
                                            stats.bytes)]}
    if cache is None:
        return out
    out["cache0"] = _flat(cache)
    for i in range(NEW):
        stats.reset()
        logits, cache = fns.decode_step(params, new[:, i], cache)
        out["logits"].append(logits)
    out["records"].append((dict(stats.counts), stats.bytes))
    out["cache1"] = _flat(cache)
    return out


def _worker(rank, init, d):
    dist.init_process_group("gloo", init_method=init, world_size=WORLD,
                            rank=rank)
    torch.set_num_threads(1)
    try:
        mesh = dist_mesh(MESH)
        torch.save({case: _serve(case, mesh, d) for case in CASES},
                   os.path.join(d, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's steps (a subprocess) beside the 4 processes'."""
    d = tmp_path_factory.mktemp("serve_dist")
    for arch in ARCHS:
        np.savez(d / f"params_{arch}.npz", **TPF._jax_params(arch))
    jax_cases = {}
    for case, (arch, mode, _) in {**CASES, "duplicate": DUPLICATE}.items():
        np.savez(d / f"serve_{case}.npz", **_inputs_np(case))
        jax_cases[case] = (arch, mode, _max_len(_cfg(arch)), NEW)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    parts = [{k: v for k, v in jax_cases.items() if k in JAX_FIRST},
             {k: v for k, v in jax_cases.items() if k not in JAX_FIRST}]
    procs = [subprocess.Popen([sys.executable, "-c", _JAX, str(d),
                               json.dumps(part), f"jax{i}.npz"],
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
            with np.load(d / f"jax{i}.npz") as z:
                ref.update(z)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    return d, ref, ranks


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_logits_match_jax_and_one_process(runs, case):
    """Every rank's prefill logits (an audio encoder's forward) and every
    decode step's, whole on each rank, within 1e-5 of the reference's
    ``jit_prefill_step``/``jit_decode_step`` on its 2x2 mesh and of the
    port's one-process steps over virtual ranks."""
    d, ref, ranks = runs
    assert f"{case}/error" not in ref, str(ref.get(f"{case}/error"))
    one = _serve(case, make_mesh(MESH, "cpu"), d)
    steps = 1 if _cfg(CASES[case][0]).family == "audio" else NEW + 1
    assert len(one["logits"]) == steps
    for r in ranks:
        assert len(r[case]["logits"]) == steps
        for i, got in enumerate(r[case]["logits"]):
            want = ref[f"{case}/logits/{i}"]
            assert tuple(got.shape) == want.shape
            _close(got, want)
            _close(got, one["logits"][i])


def _rules(case):
    arch, mode, _ = CASES[case]
    mesh = types.SimpleNamespace(shape=TPF._shape(),
                                 axis_names=("data", "model"))
    return S.ShardingRules(_cfg(arch), mesh, mode=mode)


@pytest.mark.parametrize("case", [c for c in CASES if c != "hubert"])
def test_each_rank_holds_its_cache_spec_block(runs, case):
    """After the prefill and after the last decode step each rank's cache
    is its ``cache_spec`` block of the reference's cache (every leaf
    within 1e-5, ``len`` exactly), and holds nothing more."""
    d, ref, ranks = runs
    cfg, rules = _cfg(CASES[case][0]), _rules(case)

    def same(a, b):          # the JAX layout both ways, leaf for leaf
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            return all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(map(same, a, b))
        return np.array_equal(a, b) and a.dtype == b.dtype
    for tag in ("cache0", "cache1"):
        jax_cache = TPF._unflatten(ref, f"{case}/{tag}")
        whole = cache_from_numpy(jax_cache, cfg, "cpu")
        assert same(cache_to_numpy(whole), jax_cache)
        for rank, r in enumerate(ranks):
            mesh = types.SimpleNamespace(
                shape=TPF._shape(), coords=S.rank_coords(TPF._shape(), rank))
            want = adamw.tree_leaves(S.own_cache(rules, whole, mesh))
            got = r[case][tag]
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.shape == w.shape and g.dtype == w.dtype
                _close(g, w)
    # The model axis splits some leaf: a rank holds less than the whole.
    assert any(g.numel() < w.numel() for g, w in zip(
        ranks[0][case]["cache1"], adamw.tree_leaves(whole)))


@pytest.mark.parametrize("case", list(CASES))
def test_counted_collectives_equal_the_processes(runs, case):
    """Rank 0's prefill and decode step run on a counting mesh of 2x2 on
    the meta device count the collectives and bytes the processes
    recorded."""
    d, _, ranks = runs
    arch, mode, rows = CASES[case]
    cfg = _cfg(arch)
    mesh = counting_mesh(MESH)
    fns = St.make_steps(cfg, mesh, mode=mode, ep=_ep(cfg), global_batch=rows)
    params = S.own_params(fns.rules, M.init_params(cfg, device="meta"), mesh)
    batch, new = _inputs(d, case)
    batch = {k: v.to("meta") for k, v in
             S.batch_block(fns.rules, batch, mesh).items()}
    stats = mesh.comm.stats
    stats.reset()
    with torch.no_grad():
        _, cache = fns.prefill_step(params, batch, _max_len(cfg))
    got = [(dict(stats.counts), stats.bytes)]
    if cache is not None:
        token = S.batch_block(fns.rules, {"tokens": new[:, 0]}, mesh)[
            "tokens"].to("meta")
        stats.reset()
        fns.decode_step(params, token, cache)
        got.append((dict(stats.counts), stats.bytes))
    assert got == ranks[0][case]["records"]
    assert all(n for counts, n in got)


def test_duplicate_axis_refused_alike(runs):
    """4 rows on 2x2 in zero1: the rows split over (data, model) and the
    slots over model, a spec naming ``model`` twice. The reference's
    ``jit_decode_step`` raises ``DuplicateSpecError``; the port's steps
    raise ``ValueError`` on the same input."""
    d, ref, _ = runs
    assert "DuplicateSpecError" in str(ref["duplicate/error"])
    arch, mode, rows = DUPLICATE
    cfg = _cfg(arch)
    rules = S.ShardingRules(cfg, types.SimpleNamespace(
        shape=TPF._shape(), axis_names=("data", "model")), mode=mode)
    spec = rules.cache_spec(("k",), (cfg.n_layers, rows, _max_len(cfg),
                                     cfg.n_kv_heads, cfg.hd))
    assert spec == (None, ("data", "model"), "model", None, None)
    mesh = counting_mesh(MESH)
    fns = St.make_steps(cfg, mesh, mode=mode, global_batch=rows)
    params = S.own_params(fns.rules, M.init_params(cfg, device="meta"), mesh)
    batch = {"tokens": torch.zeros((1, PROMPT), dtype=torch.long,
                                   device="meta")}
    with pytest.raises(ValueError, match="names an axis twice"):
        fns.prefill_step(params, batch, _max_len(cfg))
    with pytest.raises(ValueError, match="names an axis twice"):
        S.cache_blocks(fns.rules, rows, _max_len(cfg), mesh, "meta")
