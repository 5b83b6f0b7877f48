"""Carry parameters of the JAX package over to the port.

``params_from_numpy`` takes the JAX params tree with its leaves as numpy
arrays (``jax.tree.map(np.asarray, params)``, so this module needs no JAX) and
returns the port's params: the stacked ``[L, ...]`` block leaves become one
dict per layer. A hybrid tree keeps its shape: ``super``, a tuple over the
pattern's positions of stacked ``[n_super, ...]`` trees, becomes a tuple of
per-super-block lists of dicts; ``tail``, already one dict per layer, stays a
list of dicts.

The JAX package keeps fp32 masters and casts them to the compute dtype at
every use (``model.py:149``, ``moe.py:50``). The port stores the matrices in
the compute dtype once, which gives the same values at every use. The router,
the norm scales, ssm's ``A_log`` and ``dt_bias`` and rglru's gates and Λ stay
fp32, as the JAX code reads them in fp32.

Training casts every float leaf to the compute dtype (``adamw.cast_params``
in the JAX launcher): ``train_params_from_numpy`` does the same, and
``opt_state_from_numpy`` carries a JAX AdamW state over, so both packages
can start a run from the same params and state. Their inverses,
``train_params_to_jax`` and ``opt_state_to_jax``, stack the per-layer dicts
back into the JAX package's ``[L, ...]`` leaves: a training checkpoint's
tree is then exactly the JAX launcher's ``(params, opt_state)``, and a
checkpoint written by either package restores in the other
(``jax_train_tree``, ``restore_jax_train``). Across processes
(:class:`DistTrainLayout`) each leaf a process holds a block of is a
``checkpoint.ckpt.Sharded`` leaf of that tree: the files are the same.

A serving cache crosses the same way: ``cache_from_numpy`` takes the JAX
package's stacked cache (``init_cache``/``prefill``'s, numpy leaves) to the
port's one dict a layer, ``cache_to_numpy`` back.
"""

from __future__ import annotations

import numpy as np
import torch

from .checkpoint import ckpt as CK
from .device import resolve_device
from .optim.adamw import Zero1, tree_map

_FP32_LEAVES = ("router", "A_log", "dt_bias", "gate_a", "gate_a_b",
                "gate_x", "gate_x_b", "lam")
# The layer trees: stacked over layers (``blocks``), per pattern position
# stacked over super-blocks (``super``), or unstacked (``tail``).
_LAYERS = ("blocks", "super", "tail")


def _keeps_fp32(name: str) -> bool:
    return name in _FP32_LEAVES or name.startswith("ln")


def _convert(tree, dtype_of, device, index=None):
    out = {}
    for name, v in tree.items():
        if isinstance(v, dict):
            out[name] = _convert(v, dtype_of, device, index)
        else:
            t = torch.from_numpy(np.array(v if index is None else v[index]))
            out[name] = t.to(device=device, dtype=dtype_of(name))
    return out


def _unstack(np_params: dict, cfg, dtype_of, device) -> dict:
    dev = resolve_device(device)
    top = {k: v for k, v in np_params.items() if k not in _LAYERS}
    params = _convert(top, dtype_of, dev)
    if "blocks" in np_params:
        params["blocks"] = [_convert(np_params["blocks"], dtype_of, dev, i)
                            for i in range(cfg.n_layers)]
    if "super" in np_params:
        n_super = cfg.n_layers // len(cfg.hybrid_pattern)
        params["super"] = tuple(
            [_convert(pos, dtype_of, dev, g) for g in range(n_super)]
            for pos in np_params["super"])
        params["tail"] = [_convert(t, dtype_of, dev)
                          for t in np_params["tail"]]
    return params


def params_from_numpy(np_params: dict, cfg, device, dtype=None) -> dict:
    """JAX params tree (numpy leaves) → the port's params on ``device``.

    ``dtype`` is the matrices' storage dtype, by default the config's
    compute dtype.
    """
    dt = cfg.compute_dtype if dtype is None else dtype
    return _unstack(np_params, cfg,
                    lambda n: torch.float32 if _keeps_fp32(n) else dt,
                    device)


def train_params_from_numpy(np_params: dict, cfg, device) -> dict:
    """JAX params tree (numpy leaves) → the port's training params: every
    float leaf in the compute dtype, as ``adamw.cast_params`` casts them."""
    return _unstack(np_params, cfg, lambda n: cfg.compute_dtype, device)


def opt_state_from_numpy(np_state: dict, cfg, device) -> dict:
    """JAX AdamW state (numpy leaves) → the port's: fp32 ``m``, ``v`` and
    ``master`` trees, one dict per layer, and an int ``step``."""
    out = {k: _unstack(np_state[k], cfg, lambda n: torch.float32, device)
           for k in ("m", "v", "master")}
    out["step"] = int(np_state["step"])
    return out


def cache_from_numpy(np_cache, cfg, device) -> object:
    """The JAX package's serving cache (numpy leaves: ``[L, ...]`` stacked,
    a hybrid's ``{"super", "tail"}`` with ``[n_super, ...]`` positions)
    → the port's tree (``models.model.init_cache``) on ``device``, each
    leaf in its own dtype."""
    dev = resolve_device(device)

    def layers(tree: dict, n: int) -> list:
        return [{k: torch.from_numpy(np.array(v[i])).to(dev)
                 for k, v in tree.items()} for i in range(n)]
    if cfg.family == "hybrid":
        n_super = cfg.n_layers // len(cfg.hybrid_pattern)
        return {"super": tuple(layers(pos, n_super)
                               for pos in np_cache["super"]),
                "tail": [{k: torch.from_numpy(np.array(v)).to(dev)
                          for k, v in t.items()} for t in np_cache["tail"]]}
    return layers(np_cache, cfg.n_layers)


def cache_to_numpy(cache) -> object:
    """The port's serving cache → the JAX package's stacked tree of numpy
    arrays (a bf16 leaf as fp32, which numpy has)."""
    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def stack(layers: list) -> dict:
        return {k: np.stack([host(d[k]) for d in layers])
                for k in layers[0]}
    if isinstance(cache, dict):
        return {"super": tuple(stack(pos) for pos in cache["super"]),
                "tail": [{k: host(v) for k, v in t.items()}
                         for t in cache["tail"]]}
    return stack(cache)


def _to_jax(tree: dict, stack, leaf=lambda t: t) -> dict:
    """The JAX package's tree of a port params-like ``tree``: each list of
    per-layer dicts that JAX stacks (``blocks``, each position of
    ``super``) becomes one dict of ``stack(parts)`` leaves; every other
    tensor becomes ``leaf(tensor)``."""
    def blocks(parts: list):
        if isinstance(parts[0], dict):
            return {k: blocks([p[k] for p in parts]) for k in parts[0]}
        return stack(parts)

    def each(t):
        if isinstance(t, dict):
            return {k: each(v) for k, v in t.items()}
        return leaf(t)

    out = {k: each(v) for k, v in tree.items() if k not in _LAYERS}
    if "blocks" in tree:
        out["blocks"] = blocks(tree["blocks"])
    if "super" in tree:
        out["super"] = tuple(blocks(pos) for pos in tree["super"])
        out["tail"] = [each(t) for t in tree["tail"]]
    return out


def _host_stack(parts: list) -> torch.Tensor:
    return torch.stack([p.detach().cpu() for p in parts])


def train_params_to_jax(params: dict) -> dict:
    """The port's params → the JAX package's tree: the per-layer block dicts
    stacked into ``[L, ...]`` leaves (a hybrid's ``super`` positions into
    ``[n_super, ...]``), every leaf a host tensor in its own dtype."""
    return _to_jax(params, _host_stack, lambda t: t.detach().cpu())


def opt_state_to_jax(state: dict) -> dict:
    """The port's AdamW state → the JAX package's, as
    :func:`train_params_to_jax` does for ``m``, ``v`` and ``master``; the
    step stays an int (saved as the reference's int32 scalar)."""
    out = {k: train_params_to_jax(state[k]) for k in ("m", "v", "master")}
    out["step"] = int(state["step"])
    return out


def _sharded(tree, specs, mesh):
    """``tree`` with each tensor whose spec splits it a ``ckpt.Sharded``
    leaf (``specs`` in ``adamw.tree_leaves`` order)."""
    it = iter(specs)

    def wrap(t):
        spec = next(it)
        return (CK.Sharded(t, spec, mesh)
                if any(e is not None for e in spec) else t)
    return tree_map(wrap, tree)


def jax_train_tree(params: dict, opt_state: dict, zero=None) -> tuple:
    """The JAX launcher's ``(params, opt_state)`` tree over the port's own
    tensors, copying none: each per-layer leaf list is one
    ``checkpoint.ckpt.Stacked`` leaf. ``ckpt.save`` writes it in the JAX
    package's layout, and ``ckpt.restore(..., into=True)`` fills it in
    place. ``zero`` (an ``optim.adamw.Zero1``): this process's blocks of
    a process mesh, each a ``ckpt.Sharded`` leaf under its spec."""
    if zero is not None:
        params = _sharded(params, zero.param_specs, zero.mesh)
        opt_state = dict(opt_state, **{
            k: _sharded(opt_state[k], zero.opt_specs, zero.mesh)
            for k in ("m", "v", "master")})
    state = {k: _to_jax(opt_state[k], CK.Stacked)
             for k in ("m", "v", "master")}
    state["step"] = opt_state["step"]
    return _to_jax(params, CK.Stacked), state


def restore_jax_train(step_dir: str, params: dict, opt_state: dict,
                      zero=None) -> dict:
    """Restore a training checkpoint in the JAX package's layout into the
    port's ``params`` and ``opt_state`` in place (``opt_state["step"]``
    included), one leaf at a time; returns the manifest. ``zero``: keep
    this process's blocks (see :func:`jax_train_tree`)."""
    (_, state), manifest = CK.restore(
        step_dir, jax_train_tree(params, opt_state, zero), into=True)
    opt_state["step"] = state["step"]
    return manifest


class JaxTrainLayout:
    """``ft.runner.train_loop``'s checkpoint layout for a port training
    state: the JAX launcher's ``(params, opt_state)``."""

    tree = staticmethod(jax_train_tree)
    restore = staticmethod(restore_jax_train)


class DistTrainLayout:
    """``ft.runner.train_loop``'s checkpoint layout on a process mesh: the
    JAX launcher's ``(params, opt_state)``, each process's blocks of its
    optimizer state (``rules.opt_state_spec``: ZeRO-1's, or in tp_sp the
    param's) and params (``rules.param_spec``) gathered on rank 0, which
    writes the files (``comm``); a restore keeps each process's blocks."""

    def __init__(self, rules, mesh):
        self.rules, self.mesh = rules, mesh
        self.comm = mesh.world

    def _zero(self, params):
        return Zero1(self.rules, self.mesh, params)

    def tree(self, params: dict, opt_state: dict) -> tuple:
        return jax_train_tree(params, opt_state, self._zero(params))

    def restore(self, step_dir: str, params: dict, opt_state: dict) -> dict:
        return restore_jax_train(step_dir, params, opt_state,
                                 self._zero(params))
