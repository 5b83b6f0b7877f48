"""The training step — counterpart of ``repro.launch.steps``.

``make_train_step(cfg, opt)`` is the single-device body of
``make_steps``' ``train_step``: loss → autograd → AdamW, with the same
microbatch (``accum_steps``) policy. ``dropless=DroplessConfig(...)`` trains
the MoE through each batch's compiled schedules (``launch.dropless``), and
the step's metrics then carry the SSC cache's per-step ``ssc_*`` deltas.
Sharding rules, EP and ``grad_transform`` come with later slices and raise
here.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models import model as M
from ..optim import adamw
from .dropless import make_moe_dropless


def value_and_grad(cfg, params, batch, moe_impl=None):
    """``(loss, grads)`` of :func:`models.model.loss_fn`; ``grads`` has the
    tree and dtypes of ``params``. The MoE defaults to the kernels with
    their backward (``model.train_moe_impl``)."""
    leaves = adamw.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = M.loss_fn(cfg, params, batch, moe_impl)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    return loss.detach(), adamw.tree_map(lambda _: next(it), params)


def make_train_step(cfg, opt: Optional[adamw.OptConfig] = None, *,
                    accum_steps: int = 0, moe_impl=None, mesh=None, ep=None,
                    dropless=None, grad_transform=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with ``loss``, ``grad_norm`` and ``lr`` in ``metrics``.

    ``params`` and ``opt_state`` are updated in place (``adamw``).
    ``dropless``: a :class:`repro_torch.launch.dropless.DroplessConfig`
    switches the MoE from the fixed-capacity kernels to dropless,
    data-dependent schedules; ``train_step.dropless`` is then the
    :class:`~repro_torch.launch.dropless.DroplessMoE` handle (its cache is
    the process-level one) and ``metrics`` gain ``ssc_hits``,
    ``ssc_misses``, ``ssc_evictions``, ``ssc_entries`` and
    ``ssc_pad_ratio`` for the step. The arguments of the JAX ``make_steps``
    that a later slice brings raise if given.
    """
    for name, value, later in (
            ("mesh", mesh, "the port's EP/sharding slice"),
            ("ep", ep, "the port's EP slice"),
            ("grad_transform", grad_transform,
             "the port's sharding slice (gradient compression)")):
        if value is not None:
            raise NotImplementedError(f"{name} comes with {later}")
    dropless_moe = None
    if dropless is not None and cfg.family == "moe":
        dropless_moe = make_moe_dropless(cfg, dropless)
        moe_impl = dropless_moe.impl
    opt = opt or adamw.OptConfig()
    if accum_steps == 0:
        # Default policy: microbatch the big archs so train activations fit
        # device memory (grad accumulation is the production lever here).
        n_params = cfg.param_count()
        accum_steps = 8 if n_params > 100e9 else (4 if n_params > 10e9 else 1)

    def loss_and_grads(params, batch):
        return value_and_grad(cfg, params, batch, moe_impl)

    def train_step(params, opt_state, batch):
        B = batch["labels"].shape[0]
        if accum_steps > 1 and B % accum_steps == 0:
            mb = adamw.tree_map(
                lambda a: a.reshape((accum_steps, B // accum_steps)
                                    + tuple(a.shape[1:])), batch)
            loss, grads = adamw.accumulate_grads(loss_and_grads, params, mb)
        else:
            loss, grads = loss_and_grads(params, batch)
        params, opt_state, metrics = adamw.apply_updates(
            params, grads, opt_state, opt)
        metrics["loss"] = loss
        if dropless_moe is not None:
            for k, v in dropless_moe.step_stats().items():
                metrics[f"ssc_{k}"] = v
        return params, opt_state, metrics

    train_step.dropless = dropless_moe
    return train_step
