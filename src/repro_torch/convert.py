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
can start a run from the same params and state.
"""

from __future__ import annotations

import numpy as np
import torch

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
