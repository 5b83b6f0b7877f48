"""Carry parameters of the JAX package over to the port.

``params_from_numpy`` takes the JAX params tree with its leaves as numpy
arrays (``jax.tree.map(np.asarray, params)``, so this module needs no JAX) and
returns the port's params: the stacked ``[L, ...]`` block leaves become one
dict per layer.

The JAX package keeps fp32 masters and casts them to the compute dtype at
every use (``model.py:149``, ``moe.py:50``). The port stores the matrices in
the compute dtype once, which gives the same values at every use. The router
and the norm scales stay fp32, as the JAX code reads them in fp32.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

_FP32_LEAVES = ("router",)


def _keeps_fp32(name: str) -> bool:
    return name in _FP32_LEAVES or name.startswith("ln")


def _leaf(name: str, a, dtype, device):
    t = torch.from_numpy(np.array(a))   # a writable copy
    return t.to(device=device,
                dtype=torch.float32 if _keeps_fp32(name) else dtype)


def _convert(tree, dtype, device, index=None):
    out = {}
    for name, v in tree.items():
        if isinstance(v, dict):
            out[name] = _convert(v, dtype, device, index)
        else:
            out[name] = _leaf(name, v if index is None else v[index], dtype,
                              device)
    return out


def params_from_numpy(np_params: dict, cfg, device, dtype=None) -> dict:
    """JAX params tree (numpy leaves) → the port's params on ``device``.

    ``dtype`` is the matrices' storage dtype, by default the config's
    compute dtype.
    """
    dev = resolve_device(device)
    dt = cfg.compute_dtype if dtype is None else dtype
    top = {k: v for k, v in np_params.items() if k != "blocks"}
    params = _convert(top, dt, dev)
    params["blocks"] = [_convert(np_params["blocks"], dt, dev, i)
                        for i in range(cfg.n_layers)]
    return params
