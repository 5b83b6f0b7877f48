"""Carry parameters of the JAX package over to the port.

``params_from_numpy`` takes the JAX params tree with its leaves as numpy
arrays (``jax.tree.map(np.asarray, params)``, so this module needs no JAX) and
returns the port's params: the stacked ``[L, ...]`` block leaves become one
dict per layer.

The JAX package keeps fp32 masters and casts them to the compute dtype at
every use (``model.py:149``, ``moe.py:50``). The port stores the matrices in
the compute dtype once, which gives the same values at every use. The router
and the norm scales stay fp32, as the JAX code reads them in fp32.

Training casts every float leaf to the compute dtype (``adamw.cast_params``
in the JAX launcher): ``train_params_from_numpy`` does the same, and
``opt_state_from_numpy`` carries a JAX AdamW state over, so both packages
can start a run from the same params and state. Their inverses,
``train_params_to_jax`` and ``opt_state_to_jax``, stack the per-layer dicts
back into the JAX package's ``[L, ...]`` leaves: a training checkpoint's
tree is then exactly the JAX launcher's ``(params, opt_state)``, and a
checkpoint written by either package restores in the other
(``jax_train_tree``, ``restore_jax_train``).
"""

from __future__ import annotations

import numpy as np
import torch

from .checkpoint import ckpt as CK
from .device import resolve_device

_FP32_LEAVES = ("router",)


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
    top = {k: v for k, v in np_params.items() if k != "blocks"}
    params = _convert(top, dtype_of, dev)
    params["blocks"] = [_convert(np_params["blocks"], dtype_of, dev, i)
                        for i in range(cfg.n_layers)]
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


def _to_jax(tree: dict, stack) -> dict:
    """The JAX package's tree of a port params-like ``tree``: the list of
    per-layer ``blocks`` dicts becomes one dict of ``stack(parts)``
    leaves."""
    def blocks(parts: list):
        if isinstance(parts[0], dict):
            return {k: blocks([p[k] for p in parts]) for k in parts[0]}
        return stack(parts)
    out = {k: v for k, v in tree.items() if k != "blocks"}
    out["blocks"] = blocks(tree["blocks"])
    return out


def _host_stack(parts: list) -> torch.Tensor:
    return torch.stack([p.detach().cpu() for p in parts])


def train_params_to_jax(params: dict) -> dict:
    """The port's params → the JAX package's tree: the per-layer block dicts
    stacked into ``[L, ...]`` leaves, every leaf a host tensor in its own
    dtype."""
    return {k: v.detach().cpu() if isinstance(v, torch.Tensor) else v
            for k, v in _to_jax(params, _host_stack).items()}


def opt_state_to_jax(state: dict) -> dict:
    """The port's AdamW state → the JAX package's, as
    :func:`train_params_to_jax` does for ``m``, ``v`` and ``master``; the
    step stays an int (saved as the reference's int32 scalar)."""
    out = {k: train_params_to_jax(state[k]) for k in ("m", "v", "master")}
    out["step"] = int(state["step"])
    return out


def jax_train_tree(params: dict, opt_state: dict) -> tuple:
    """The JAX launcher's ``(params, opt_state)`` tree over the port's own
    tensors, copying none: each per-layer leaf list is one
    ``checkpoint.ckpt.Stacked`` leaf. ``ckpt.save`` writes it in the JAX
    package's layout, and ``ckpt.restore(..., into=True)`` fills it in
    place."""
    state = {k: _to_jax(opt_state[k], CK.Stacked)
             for k in ("m", "v", "master")}
    state["step"] = opt_state["step"]
    return _to_jax(params, CK.Stacked), state


def restore_jax_train(step_dir: str, params: dict, opt_state: dict) -> dict:
    """Restore a training checkpoint in the JAX package's layout into the
    port's ``params`` and ``opt_state`` in place (``opt_state["step"]``
    included), one leaf at a time; returns the manifest."""
    (_, state), manifest = CK.restore(
        step_dir, jax_train_tree(params, opt_state), into=True)
    opt_state["step"] = state["step"]
    return manifest


class JaxTrainLayout:
    """``ft.runner.train_loop``'s checkpoint layout for a port training
    state: the JAX launcher's ``(params, opt_state)``."""

    tree = staticmethod(jax_train_tree)
    restore = staticmethod(restore_jax_train)
