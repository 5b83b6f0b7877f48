"""The port's checkpoints (``repro_torch.checkpoint.ckpt``) against the JAX
package's, on the CPU.

The reference's checkpoint tests held in the port; the training state of
the smoke config written by both packages, whose manifests must be equal as
JSON and whose npz arrays must be equal bit for bit; each package restoring
the other's directory bit for bit, in fp32 and bf16; and the SIGKILL
atomicity test, in a child that imports only the port's ``ckpt``. Every
test writes under its own ``tmp_path`` and clears any fault hook it
installs.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import ckpt as JCK  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.checkpoint import ckpt as CK  # noqa: E402
from repro_torch.configs import get_smoke_config as tget_smoke  # noqa: E402
from repro_torch.convert import (jax_train_tree,  # noqa: E402
                                 opt_state_from_numpy, opt_state_to_jax,
                                 restore_jax_train, train_params_from_numpy,
                                 train_params_to_jax)
from repro_torch.optim.adamw import tree_leaves  # noqa: E402

ARCH = "granite-moe-3b-a800m"
REPO = os.path.join(os.path.dirname(__file__), os.pardir)


def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.ones(5) * 2,
                       "t": (torch.zeros(2, 2), torch.full((3,), 7.0))}}


# ---------------------------------------------------------------------------
# The reference's checkpoint tests (tests/test_checkpoint_optim.py:24-62).
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    CK.save(str(tmp_path), 7, tree)
    d = CK.latest_step_dir(str(tmp_path))
    restored, manifest = CK.restore(d, tree)
    assert manifest["step"] == 7
    assert isinstance(restored["nested"]["t"], tuple)
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        assert torch.equal(a, b)


def test_checkpoint_incomplete_ignored(tmp_path):
    tree = _tree()
    CK.save(str(tmp_path), 1, tree)
    # simulate a crashed save: dir without _COMPLETE
    os.makedirs(tmp_path / "step_00000002")
    (tmp_path / "latest").write_text("step_00000002")
    d = CK.latest_step_dir(str(tmp_path))
    assert d.endswith("step_00000001")


def test_checkpoint_checksum_detects_corruption(tmp_path):
    tree = _tree()
    d = CK.save(str(tmp_path), 3, tree)
    shard = os.path.join(d, "shard_00000.npz")
    with np.load(shard) as f:
        data = dict(f)
    first = sorted(data)[0]
    data[first] = data[first] + 1
    np.savez(shard, **data)
    with pytest.raises(IOError, match="checksum"):
        CK.restore(d, tree)
    restored, _ = CK.restore(d, tree, verify=False)
    assert torch.equal(restored["a"], tree["a"] + 1)


def test_checkpoint_gc(tmp_path):
    for s in (1, 2, 3, 4, 5):
        CK.save(str(tmp_path), s, {"x": torch.ones(3)})
    CK.gc_old(str(tmp_path), keep=2)
    dirs = [d for d in os.listdir(tmp_path) if d.startswith("step_")]
    assert sorted(dirs) == ["step_00000004", "step_00000005"]


# ---------------------------------------------------------------------------
# Leaves, keys and the fault hook, against the reference.
# ---------------------------------------------------------------------------


def test_keys_dtypes_and_scalars_equal_the_reference(tmp_path):
    """Sorted dict keys, list and tuple indices, ``None`` as an empty
    subtree; bf16 as uint16 bits; a Python int as the int32 scalar: the
    port's manifest equals the reference's."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    b = rng.standard_normal((4,)).astype(np.float32)
    port = {"z": [torch.from_numpy(w), None,
                  (torch.tensor(3, dtype=torch.int32),)],
            "a": {"bf": torch.from_numpy(b).bfloat16(), "step": 5,
                  "i64": torch.arange(4)}}
    ref = {"z": [jnp.asarray(w), None, (jnp.asarray(3, jnp.int32),)],
           "a": {"bf": jnp.asarray(b, jnp.bfloat16),
                 "step": jnp.asarray(5, jnp.int32),
                 "i64": np.arange(4, dtype=np.int64)}}
    CK.save(str(tmp_path / "port"), 1, port)
    JCK.save(str(tmp_path / "jax"), 1, ref)
    mp = _manifest(tmp_path / "port" / "step_00000001")
    mj = _manifest(tmp_path / "jax" / "step_00000001")
    assert mp == mj
    assert sorted(mp["leaves"]) == ["a/bf", "a/i64", "a/step", "z/0",
                                    "z/2/0"]
    assert mp["leaves"]["a/bf"]["dtype"] == "bfloat16"
    assert mp["leaves"]["a/step"] == dict(mj["leaves"]["a/step"],
                                          dtype="int32", shape=[])
    _npz_equal(tmp_path / "port" / "step_00000001",
               tmp_path / "jax" / "step_00000001", mp)
    back, _ = CK.restore(str(tmp_path / "port" / "step_00000001"), port)
    assert back["a"]["step"] == 5 and isinstance(back["a"]["step"], int)
    assert back["z"][1] is None
    assert back["a"]["bf"].dtype == torch.bfloat16
    assert torch.equal(back["a"]["bf"], port["a"]["bf"])


def test_restore_casts_to_the_target_leaf(tmp_path):
    """Each leaf comes back in the dtype of ``tree_like``'s leaf (the
    port's counterpart of the reference's ``shardings``)."""
    tree = {"w": torch.arange(6.0).reshape(2, 3)}
    CK.save(str(tmp_path), 1, tree)
    back, _ = CK.restore(CK.latest_step_dir(str(tmp_path)),
                         {"w": torch.empty(0, dtype=torch.float64)})
    assert back["w"].dtype == torch.float64
    assert torch.equal(back["w"], tree["w"].double())


def test_restore_into_fills_the_given_tensors_in_place(tmp_path):
    """``into=True`` copies each stored array into the tree's own tensors
    (a ``Stacked`` leaf row by row, saved as its stack) and returns those
    tensors; a shape that differs raises instead of broadcasting."""
    rows = [torch.arange(3.0) + 3 * i for i in range(2)]
    d = CK.save(str(tmp_path), 1,
                {"n": 3, "s": CK.Stacked(rows), "w": torch.arange(4.0)})
    with np.load(os.path.join(d, "shard_00000.npz")) as f:
        np.testing.assert_array_equal(f["s"], torch.stack(rows).numpy())
    dst_rows = [torch.zeros(3), torch.zeros(3)]
    dst = {"n": 0, "s": CK.Stacked(dst_rows), "w": torch.zeros(4)}
    back, _ = CK.restore(d, dst, into=True)
    assert back["n"] == 3
    assert back["s"] is dst["s"] and back["w"] is dst["w"]
    assert torch.equal(dst["w"], torch.arange(4.0))
    assert all(torch.equal(a, b) for a, b in zip(dst_rows, rows))
    with pytest.raises(ValueError, match="stored shape"):
        CK.restore(d, {"n": 0, "s": CK.Stacked(rows[:1]),
                       "w": torch.zeros(4)}, into=True)
    with pytest.raises(ValueError, match="stored shape"):
        CK.restore(d, {"n": 0, "s": CK.Stacked(rows),
                       "w": torch.zeros(1, 4)}, into=True)


def test_fault_hook_ops_equal_the_reference(tmp_path):
    ops = {"port": [], "jax": []}
    try:
        CK.set_file_fault_hook(ops["port"].append)
        JCK.set_file_fault_hook(ops["jax"].append)
        CK.save(str(tmp_path / "port"), 2, {"w": torch.ones(3)})
        JCK.save(str(tmp_path / "jax"), 2, {"w": jnp.ones(3)})
    finally:
        CK.set_file_fault_hook(None)
        JCK.set_file_fault_hook(None)
    assert ops["port"] == ops["jax"] == [
        "mkdir_tmp", "write_shard", "write_manifest", "write_complete",
        "rename_final", "write_latest", "replace_latest"]


def test_a_raising_hook_leaves_the_previous_checkpoint(tmp_path):
    """A save that dies before any of its file ops leaves ``latest``
    resolving to the previous checkpoint, intact."""
    CK.save(str(tmp_path), 1, {"w": torch.ones(3)})
    for op in ("mkdir_tmp", "write_shard", "write_manifest",
               "write_complete", "rename_final", "write_latest",
               "replace_latest"):
        def hook(o, op=op):
            if o == op:
                raise RuntimeError(op)
        try:
            CK.set_file_fault_hook(hook)
            with pytest.raises(RuntimeError, match=op):
                CK.save(str(tmp_path), 2, {"w": torch.zeros(3)})
        finally:
            CK.set_file_fault_hook(None)
        d = CK.latest_step_dir(str(tmp_path))
        assert d.endswith("step_00000001"), (op, d)
        back, _ = CK.restore(d, {"w": torch.empty(0)})
        assert torch.equal(back["w"], torch.ones(3))
        for name in os.listdir(tmp_path):
            if name.startswith("step_00000002"):
                shutil.rmtree(tmp_path / name)


# ---------------------------------------------------------------------------
# The smoke training state, written by both packages.
# ---------------------------------------------------------------------------


def _manifest(step_dir):
    with open(os.path.join(step_dir, "manifest.json")) as f:
        return json.load(f)


def _npz_equal(dir_a, dir_b, manifest):
    for shard in manifest["shards"]:
        with np.load(os.path.join(dir_a, shard)) as fa, \
                np.load(os.path.join(dir_b, shard)) as fb:
            assert sorted(fa.files) == sorted(fb.files)
            for k in fa.files:
                a, b = fa[k], fb[k]
                assert a.dtype == b.dtype and a.shape == b.shape, k
                assert a.tobytes() == b.tobytes(), k


def _state(dtype, arch=ARCH):
    """The smoke config's training state, made once in numpy: JAX's
    ``init_params`` (seed 0), moments and masters from a seeded numpy
    generator, step 7; as the JAX tree and as the port's."""
    jcfg = dataclasses.replace(jget_smoke(arch), dtype=dtype)
    tcfg = dataclasses.replace(tget_smoke(arch), dtype=dtype)
    np_params = jax.tree.map(
        np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)

    def rand(a):
        return rng.standard_normal(a.shape).astype(np.float32)

    np_state = {"m": jax.tree.map(rand, np_params),
                "v": jax.tree.map(lambda a: np.abs(rand(a)), np_params),
                "master": jax.tree.map(rand, np_params), "step": 7}
    jparams = jadamw.cast_params(jax.tree.map(jnp.asarray, np_params),
                                 jcfg.compute_dtype)
    jstate = {k: jax.tree.map(jnp.asarray, np_state[k])
              for k in ("m", "v", "master")}
    jstate["step"] = jnp.asarray(7, jnp.int32)
    tparams = train_params_from_numpy(np_params, tcfg, "cpu")
    tstate = opt_state_from_numpy(np_state, tcfg, "cpu")
    return tcfg, (jparams, jstate), (tparams, tstate)


_EXTRA = {"metrics_log": [{"step": 2, "loss": 1.5, "grad_norm": 0.25,
                           "step_time_s": 0.125}], "stragglers": []}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_training_checkpoint_layout_equals_the_reference(tmp_path, dtype):
    tcfg, jtree, (tparams, tstate) = _state(dtype)
    JCK.save(str(tmp_path / "jax"), 2, jtree, extra=_EXTRA)
    CK.save(str(tmp_path / "port"), 2, jax_train_tree(tparams, tstate),
            extra=_EXTRA)
    dj = tmp_path / "jax" / "step_00000002"
    dp = tmp_path / "port" / "step_00000002"
    mj, mp = _manifest(dj), _manifest(dp)
    assert mp == mj
    assert mp["leaves"]["1/step"]["dtype"] == "int32"
    assert mp["leaves"]["0/blocks/moe/w_in"]["dtype"] == dtype
    assert mp["leaves"]["0/blocks/moe/w_in"]["shape"][0] == tcfg.n_layers
    _npz_equal(dj, dp, mp)
    assert sorted(os.listdir(dj)) == sorted(os.listdir(dp)) == [
        "_COMPLETE", "manifest.json", "shard_00000.npz"]
    assert (tmp_path / "jax" / "latest").read_text() == \
        (tmp_path / "port" / "latest").read_text() == "step_00000002"


def _bits(a):
    return np.asarray(a).tobytes()


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros_like(v) for v in tree)
    return 0 if isinstance(tree, int) else torch.zeros_like(tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_each_package_restores_the_others_checkpoint(tmp_path, dtype):
    tcfg, jtree, (tparams, tstate) = _state(dtype)
    JCK.save(str(tmp_path / "jax"), 4, jtree)
    CK.save(str(tmp_path / "port"), 4, jax_train_tree(tparams, tstate))

    # The JAX package restores the port's directory.
    got, manifest = JCK.restore(
        JCK.latest_step_dir(str(tmp_path / "port")), jtree)
    assert manifest["step"] == 4
    jl, gl = jax.tree.leaves(jtree), jax.tree.leaves(got)
    assert len(jl) == len(gl) == 49
    for a, b in zip(jl, gl):
        assert a.dtype == b.dtype and _bits(a) == _bits(b)

    # The port restores the JAX package's directory into a fresh state of
    # its own layout, in place.
    params, state = _zeros_like(tparams), _zeros_like(tstate)
    manifest = restore_jax_train(
        CK.latest_step_dir(str(tmp_path / "jax")), params, state)
    assert manifest["step"] == 4
    assert state["step"] == 7 and isinstance(state["step"], int)
    want, back = tree_leaves((tparams, tstate)), tree_leaves((params, state))
    assert len(want) == len(back)
    fresh = tree_leaves((params, state))
    assert all(a is b for a, b in zip(fresh, back)
               if isinstance(a, torch.Tensor))
    for a, b in zip(want, back):
        if isinstance(a, int):
            assert a == b
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_to_jax_inverts_from_numpy():
    """``train_params_to_jax``/``opt_state_to_jax`` give back the stacked
    numpy leaves ``*_from_numpy`` took, in fp32."""
    tcfg, _, (tparams, tstate) = _state("float32")
    jcfg = jget_smoke(ARCH)
    np_params = jax.tree.map(
        np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    back = train_params_to_jax(tparams)
    flat_np = jax.tree_util.tree_leaves_with_path(np_params)
    assert len(flat_np) == len(tree_leaves(back))
    for path, a in flat_np:
        t = back
        for k in path:
            t = t[k.key]
        np.testing.assert_array_equal(t.numpy(), a)
    st = opt_state_to_jax(tstate)
    assert st["step"] == 7
    assert st["m"]["blocks"]["moe"]["w_in"].shape[0] == tcfg.n_layers


@pytest.mark.parametrize("arch, n_leaves", [("qwen2-1_5b", 4 * 13 + 1),
                                            ("recurrentgemma-2b",
                                             4 * 66 + 1)])
def test_dense_and_hybrid_checkpoints_cross_packages(tmp_path, arch,
                                                     n_leaves):
    """A dense (qwen2: biases, tied embeddings) and the hybrid
    (recurrentgemma: the ``super`` tuple's index keys, the unstacked
    ``tail``) training checkpoint, bf16: the port writes JAX's manifest and
    npz bits, and each package restores the other's directory bit for
    bit."""
    tcfg, jtree, (tparams, tstate) = _state("bfloat16", arch)
    JCK.save(str(tmp_path / "jax"), 3, jtree)
    CK.save(str(tmp_path / "port"), 3, jax_train_tree(tparams, tstate))
    dj, dp = (JCK.latest_step_dir(str(tmp_path / k)) for k in ("jax",
                                                             "port"))
    mj, mp = _manifest(dj), _manifest(dp)
    assert mp == mj and len(mp["leaves"]) == n_leaves
    _npz_equal(dj, dp, mp)
    if tcfg.family == "hybrid":
        assert "0/super/2/attn/wq" in mp["leaves"]
        assert "0/tail/1/rglru/lam" in mp["leaves"]
        assert mp["leaves"]["0/super/0/rglru/lam"]["shape"][0] == 1

    got, _ = JCK.restore(dp, jtree)
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(got)):
        assert a.dtype == b.dtype and _bits(a) == _bits(b)
    params, state = _zeros_like(tparams), _zeros_like(tstate)
    restore_jax_train(dj, params, state)
    for a, b in zip(tree_leaves((tparams, tstate)),
                    tree_leaves((params, state))):
        if isinstance(a, int):
            assert a == b
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# Atomicity under SIGKILL (twin of tests/test_ft_restart.py:104-162).
# ---------------------------------------------------------------------------

_ATOMICITY_CHILD = r"""
import os, shutil, signal, sys

sys.path.insert(0, sys.argv[2])
import torch
torch.set_num_threads(1)            # no intra-op pool before the forks
from repro_torch.checkpoint import ckpt as CK

d = sys.argv[1]
tree = {"w": torch.arange(8, dtype=torch.float32)}
CK.save(d, 1, tree)
base = CK.latest_step_dir(d)
assert base.endswith("step_00000001"), base

N = 0
while True:
    N += 1
    assert N < 20, "fault hook never let save() finish"
    pid = os.fork()
    if pid == 0:
        # Grandchild: SIGKILL ourselves immediately before file op N.
        count = {"n": 0}
        def hook(op):
            count["n"] += 1
            if count["n"] == N:
                os.kill(os.getpid(), signal.SIGKILL)
        CK.set_file_fault_hook(hook)
        CK.save(d, 2, {"w": torch.arange(8, dtype=torch.float32) * 2})
        os._exit(0)
    _, status = os.waitpid(pid, 0)
    resolved = CK.latest_step_dir(d)
    # The resolved checkpoint is never partial: sentinel present and a
    # CRC-verified restore succeeds, no matter where the writer died.
    assert resolved is not None, N
    assert os.path.exists(os.path.join(resolved, "_COMPLETE")), (N, resolved)
    back, _ = CK.restore(resolved, tree)
    if os.WIFEXITED(status) and os.WEXITSTATUS(status) == 0:
        # save() ran to completion: every kill point was exercised.
        assert resolved.endswith("step_00000002"), resolved
        assert torch.equal(back["w"], tree["w"] * 2)
        break
    assert os.WIFSIGNALED(status), (N, status)
    assert resolved == base, (N, resolved)
    assert torch.equal(back["w"], tree["w"])
    for name in os.listdir(d):     # reset partial state for the next N
        if name.startswith("step_00000002"):
            shutil.rmtree(os.path.join(d, name))
mods = sorted(m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"))
assert not mods, mods
print("OK", N)
"""


def test_checkpoint_atomicity_under_sigkill(tmp_path):
    """SIGKILL the port's checkpoint writer before every file op in turn;
    ``latest_step_dir`` never resolves to a partial checkpoint."""
    script = tmp_path / "atomicity_child.py"
    script.write_text(_ATOMICITY_CHILD)
    r = subprocess.run(
        [sys.executable, str(script), str(tmp_path / "ck"),
         os.path.join(REPO, "src")],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.split() == ["OK", "8"], r.stdout
