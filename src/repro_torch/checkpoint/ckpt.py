"""Sharded checkpoints — counterpart of ``repro.checkpoint.ckpt``, in its
layout byte for byte, so a checkpoint written by either package restores in
the other.

Layout:
    <dir>/step_000042/
        manifest.json        # tree structure, shapes, dtypes, checksums
        shard_00000.npz      # flat {leaf_key: array} chunks of 64 leaves
        ...
        _COMPLETE            # written last — incomplete dirs are ignored
    <dir>/latest             # text file with the newest complete step dir

A tree is nested dicts, lists and tuples whose leaves are tensors, Python
ints or :class:`Stacked` lists of tensors. A leaf's key is its path joined
by ``/``: dict keys in sorted order, list and tuple items by index, as JAX
flattens a pytree; ``None`` is an empty subtree, as in JAX. Leaves are saved
as host arrays in their own dtype. bfloat16, which npz cannot store, is
saved as its uint16 bits with ``"dtype": "bfloat16"`` in the manifest
(through ``tensor.view(torch.int16)``, so no bfloat16 numpy type is
needed). A Python int is saved as the int32 scalar the reference's optimizer
step is. Each leaf's CRC32 is taken over the stored bytes.

Save and ``restore(..., into=True)`` hold one leaf on the host at a time and
no copy of a leaf on the device: a state that fills the card can be saved
and restored in place.
"""

from __future__ import annotations

import json
import os
import shutil
import zipfile
import zlib

import numpy as np
import torch

_SHARD_LEAVES = 64  # leaves per npz shard

# Fault-injection seam for the atomicity tests: every state-changing file
# operation of save() announces itself through this hook, so a harness can
# kill the writer between any two operations and check that latest_step_dir
# never resolves to the partial checkpoint. Production never installs one.
_file_hook = None


def set_file_fault_hook(hook) -> None:
    """Install (``None`` clears) the ``save()`` file-op callback.

    ``hook(op)`` runs immediately *before* each file-mutating operation:
    ``mkdir_tmp``, ``write_shard``, ``write_manifest``, ``write_complete``,
    ``rename_final``, ``write_latest``, ``replace_latest``. The hook may
    raise or kill the process — the atomicity contract is that no prefix of
    these operations leaves a state ``latest_step_dir`` would resolve to.
    """
    global _file_hook
    _file_hook = hook


def _file_op(op: str) -> None:
    if _file_hook is not None:
        _file_hook(op)


class Stacked:
    """One leaf held as ``parts``, the rows of ``torch.stack(parts)``, so a
    per-layer list of tensors saves as the reference's stacked ``[L, ...]``
    leaf: ``save`` stacks the rows on the host for this leaf alone, and
    ``restore(..., into=True)`` copies row ``i`` into ``parts[i]``."""

    def __init__(self, parts):
        self.parts = list(parts)

    @property
    def shape(self) -> torch.Size:
        return torch.Size((len(self.parts), *self.parts[0].shape))


def _to_storable(leaf) -> tuple[np.ndarray, str]:
    """(the array npz stores, the manifest's dtype name) of one leaf."""
    if isinstance(leaf, Stacked):
        rows = torch.empty(leaf.shape, dtype=leaf.parts[0].dtype)
        for row, part in zip(rows, leaf.parts):
            row.copy_(part.detach())
        leaf = rows
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    elif isinstance(leaf, int):
        a = np.asarray(leaf, dtype=np.int32)
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _crc32(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).reshape(-1).view(np.uint8))


def _flatten(tree, prefix=()):
    """``(path, leaf)`` pairs in JAX's flatten order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _unflatten(tree, load, prefix=()):
    """``tree``'s structure with each leaf replaced by ``load(key, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], load, prefix + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, load, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return load("/".join(prefix), tree)


def _write_npz(path: str, arrays) -> None:
    """The file ``np.savez(path, **dict(arrays))`` writes, from an iterator
    of ``(name, array)`` pairs, one array in memory at a time."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, a in arrays:
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, a, allow_pickle=False)


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None) -> str:
    """Write ``tree`` as ``<ckpt_dir>/step_<step>`` and point ``latest`` at
    it; returns the step directory. ``extra`` (JSON-safe) rides the
    manifest."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    _file_op("mkdir_tmp")
    os.makedirs(tmp)

    flat = dict(_flatten(tree))
    keys = sorted(flat)
    manifest = {"step": step, "extra": extra or {}, "leaves": {},
                "shards": []}

    def stored(shard_keys, shard_name):
        for k in shard_keys:
            a, dtype = _to_storable(flat[k])
            manifest["leaves"][k] = {
                "shape": list(a.shape), "dtype": dtype,
                "shard": shard_name, "crc32": _crc32(a),
            }
            yield k.replace("/", "__"), a

    for si in range(0, len(keys), _SHARD_LEAVES):
        shard_name = f"shard_{si // _SHARD_LEAVES:05d}.npz"
        _file_op("write_shard")
        _write_npz(os.path.join(tmp, shard_name),
                   stored(keys[si:si + _SHARD_LEAVES], shard_name))
        manifest["shards"].append(shard_name)
    _file_op("write_manifest")
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    _file_op("write_complete")
    with open(os.path.join(tmp, "_COMPLETE"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    _file_op("rename_final")
    os.rename(tmp, final)
    _file_op("write_latest")
    with open(os.path.join(ckpt_dir, "latest.tmp"), "w") as f:
        f.write(os.path.basename(final))
    _file_op("replace_latest")
    os.replace(os.path.join(ckpt_dir, "latest.tmp"),
               os.path.join(ckpt_dir, "latest"))
    return final


def _complete_step_dirs(ckpt_dir: str) -> list:
    return sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                  and os.path.exists(os.path.join(ckpt_dir, d, "_COMPLETE")))


def latest_step_dir(ckpt_dir: str) -> str | None:
    """The newest complete step directory, or ``None``."""
    ptr = os.path.join(ckpt_dir, "latest")
    if os.path.exists(ptr):
        with open(ptr) as f:
            cand = os.path.join(ckpt_dir, f.read().strip())
        if os.path.exists(os.path.join(cand, "_COMPLETE")):
            return cand
    # Fallback: newest complete dir (covers a crashed `latest` update).
    if not os.path.isdir(ckpt_dir):
        return None
    dirs = _complete_step_dirs(ckpt_dir)
    return os.path.join(ckpt_dir, dirs[-1]) if dirs else None


@torch.no_grad()
def _from_stored(key: str, a: np.ndarray, dtype: str, like, into: bool):
    """A stored array as a leaf like ``like``: an int, a tensor on
    ``like``'s device and in its dtype, or, ``into``, ``like`` itself with
    the array copied into it."""
    if isinstance(like, int):
        return int(a)
    t = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
         if dtype == "bfloat16" else torch.from_numpy(a))
    if not into:
        return t.to(device=like.device, dtype=like.dtype)
    if t.shape != like.shape:
        raise ValueError(f"{key}: stored shape {tuple(t.shape)} != "
                         f"{tuple(like.shape)}")
    for dst, src in (zip(like.parts, t) if isinstance(like, Stacked)
                     else ((like, t),)):
        dst.copy_(src)
    return like


def restore(step_dir: str, tree_like, *, verify: bool = True,
            into: bool = False):
    """``(tree, manifest)``: the checkpoint in ``step_dir`` in the structure
    of ``tree_like``, each leaf on the device and in the dtype of
    ``tree_like``'s matching leaf (the counterpart of the reference's
    ``shardings``; the checkpoint holds logical arrays, so it restores into
    any placement). ``verify`` checks every leaf's CRC32.

    ``into=True`` restores in place: each stored array is copied into
    ``tree_like``'s tensor (or :class:`Stacked` rows) of the same shape,
    one leaf at a time, and the tree returned holds those same tensors and
    the stored ints."""
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)

    cache: dict = {}

    def load_leaf(key: str, like):
        info = manifest["leaves"][key]
        shard = info["shard"]
        if shard not in cache:
            cache[shard] = np.load(os.path.join(step_dir, shard))
        a = cache[shard][key.replace("/", "__")]
        if verify and _crc32(a) != info["crc32"]:
            raise IOError(f"checksum mismatch for {key} in {step_dir}")
        return _from_stored(key, a, info["dtype"], like, into)

    try:
        tree = _unflatten(tree_like, load_leaf)
    finally:
        for npz in cache.values():
            npz.close()
    return tree, manifest


def gc_old(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` complete step directories."""
    for d in _complete_step_dirs(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d))
