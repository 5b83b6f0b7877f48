"""Train, prefill and decode steps — counterpart of ``repro.launch.steps``.

``make_train_step(cfg, opt)`` is the body of ``make_steps``' ``train_step``:
loss → autograd → AdamW, with the same microbatch (``accum_steps``) policy.
``dropless=DroplessConfig(...)`` trains the MoE through each batch's
compiled schedules (``launch.dropless``), and the step's metrics then carry
the SSC cache's per-step ``ssc_*`` deltas. ``mesh`` and ``ep`` run the MoE
expert-parallel over the mesh's model axis (``parallel.ep.make_moe_ep``).

``make_steps(cfg, mesh, ...)`` returns the three steps with EP as the MoE
of each and flash decoding in the decode step, and the mode's
``parallel.sharding.ShardingRules`` (``StepFns.rules``). On a mesh of
virtual ranks the rules place nothing (one process holds every value), and
of the three modes only what changes values is kept: ``ep_dp`` sets
``EPConfig.dp_batch``.

On a process mesh (``launch.mesh.dist_mesh(dims)``; the zero1 and ep_dp
modes, one rank a process) the train step takes this rank's rows and
params (ep_dp: its own experts) and a ZeRO-1 optimizer state
(``adamw.init_opt_state(params, rules, mesh)``). After the backward it
mean-reduces each grad over the ranks that hold other rows: every rank for
a leaf each rank computed from its own rows, the data axes only for the
experts under EP, whose grads the EP program already summed over the model
group. The loss is the mean over the ranks. ``tp_sp`` across processes
(tensor and sequence parallelism inside the layers) is not ported and
raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..models import model as M
from ..optim import adamw
from ..parallel.ep import EPConfig, make_moe_ep
from ..parallel.sharding import ShardingRules, expert_leaves
from .dropless import make_moe_dropless

MODES = ("tp_sp", "zero1", "ep_dp")
_TP_SP_ACROSS_PROCESSES = (
    "tp_sp across processes needs tensor and sequence parallelism inside "
    "the layers, which is not ported (ROADMAP Queue 1 · 1: tp_sp across "
    "processes with FSDP); train across processes in zero1 or ep_dp")


@dataclasses.dataclass
class StepFns:
    train_step: object
    prefill_step: object
    decode_step: object
    ep_cfg: Optional[EPConfig]
    # The dropless path's DroplessMoE handle (its SSC cache) when active.
    dropless: Optional[object] = None
    rules: Optional[ShardingRules] = None


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


def reduce_grads(grads, mesh, experts_summed: bool):
    """The mean of the ranks' grads on a process mesh, in place: each leaf
    summed over every rank, the experts over the data axes alone when
    ``experts_summed`` (EP summed them over the model group), and divided
    by the world size: the rows of every rank carry one share of the
    batch's mean."""
    n = math.prod(mesh.shape.values())
    world = mesh.world
    data = mesh.axes_comm(tuple(a for a in mesh.axis_names if a != "model"))
    flags = expert_leaves(grads)
    for g, expert in zip(adamw.tree_leaves(grads), flags):
        comm = data if expert and experts_summed else world
        g.copy_(comm.all_reduce(g).div_(n))
    return grads


def make_train_step(cfg, opt: Optional[adamw.OptConfig] = None, *,
                    accum_steps: int = 0, moe_impl=None, mesh=None, ep=None,
                    dropless=None, grad_transform=None, rules=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with ``loss``, ``grad_norm`` and ``lr`` in ``metrics``.
    ``batch`` holds ``tokens`` and ``labels`` (a vlm's may add
    ``patches``; an audio encoder's is ``features`` and ``labels``).

    ``params`` and ``opt_state`` are updated in place (``adamw``).
    ``dropless``: a :class:`repro_torch.launch.dropless.DroplessConfig`
    switches the MoE from the fixed-capacity kernels to dropless,
    data-dependent schedules; ``train_step.dropless`` is then the
    :class:`~repro_torch.launch.dropless.DroplessMoE` handle (its cache is
    the process-level one) and ``metrics`` gain ``ssc_hits``,
    ``ssc_misses``, ``ssc_evictions``, ``ssc_entries`` and
    ``ssc_pad_ratio`` for the step. ``ep``: an :class:`EPConfig` runs the
    MoE expert-parallel over ``mesh``'s model axis (a mesh of virtual ranks
    places nothing). ``grad_transform`` runs on the grads before the update
    (``adamw.apply_updates``). ``rules`` (the zero1 or ep_dp mode's) and a
    process ``mesh``: the step of this rank (see the module docstring).
    """
    dist_step = rules is not None and getattr(mesh, "local_rows", False)
    if rules is not None and not dist_step:
        raise ValueError("rules= places a step on a process mesh "
                         "(launch.mesh.dist_mesh(dims)); pass mesh= too")
    if dist_step and rules.mode == "tp_sp" and math.prod(
            mesh.shape.values()) > 1:
        raise ValueError(_TP_SP_ACROSS_PROCESSES)
    if dist_step and dropless is not None:
        raise ValueError("the dropless path trains in one process; across "
                         "processes the MoE runs the fixed-capacity EP")
    ep_moe = ep is not None and cfg.family == "moe"
    if ep_moe:
        if mesh is None:
            raise ValueError("ep= needs the mesh= whose model axis it runs on")
        moe_impl = make_moe_ep(mesh, ep, cfg.act, local_experts=(
            dist_step and rules.mode == "ep_dp"))
    elif dist_step and rules.mode == "ep_dp" and cfg.family == "moe":
        raise ValueError("ep_dp holds each rank's experts: pass ep=")
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
        zero = {}
        if dist_step:
            n = math.prod(mesh.shape.values())
            loss = mesh.world.all_reduce(loss.reshape(1))[0] / n
            grads = reduce_grads(grads, mesh, experts_summed=ep_moe)
            zero = {"rules": rules, "mesh": mesh}
        params, opt_state, metrics = adamw.apply_updates(
            params, grads, opt_state, opt, grad_transform=grad_transform,
            **zero)
        metrics["loss"] = loss
        if dropless_moe is not None:
            for k, v in dropless_moe.step_stats().items():
                metrics[f"ssc_{k}"] = v
        return params, opt_state, metrics

    train_step.dropless = dropless_moe
    return train_step


def make_steps(cfg, mesh, *, opt: Optional[adamw.OptConfig] = None,
               ep: Optional[EPConfig] = None, mode: str = "tp_sp",
               dropless=None, grad_transform=None, accum_steps: int = 0,
               flash_decode: bool = True) -> StepFns:
    """The train, prefill and decode steps over ``mesh``.

    EP (``ep``) is the MoE of all three; ``dropless`` replaces it in
    training only, as in the reference. An audio encoder's prefill step is
    its forward, ``(logits, None)``. The decode step uses flash
    decoding when ``flash_decode`` is set, the mesh's model axis is larger
    than 1 and the config has heads; without it the dense one-token
    attention runs.
    """
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    rules = ShardingRules(cfg, mesh, mode=mode)
    dist_step = getattr(mesh, "local_rows", False)
    if dist_step and mode == "tp_sp" and math.prod(mesh.shape.values()) > 1:
        raise ValueError(_TP_SP_ACROSS_PROCESSES)
    if mode == "ep_dp" and ep is not None:
        ep = dataclasses.replace(ep, dp_batch=True)
    if dist_step:
        train_step = make_train_step(
            cfg, opt, accum_steps=accum_steps, mesh=mesh, ep=ep,
            dropless=dropless, grad_transform=grad_transform, rules=rules)

        def serving(*_args, **_kw):
            raise ValueError("serving runs in one process, as in the "
                             "reference (launch.serve uses no mesh)")
        return StepFns(train_step=train_step, prefill_step=serving,
                       decode_step=serving, ep_cfg=ep,
                       dropless=train_step.dropless, rules=rules)
    moe_impl = (make_moe_ep(mesh, ep, cfg.act)
                if ep is not None and cfg.family == "moe" else None)
    train_step = make_train_step(cfg, opt, accum_steps=accum_steps,
                                 moe_impl=moe_impl, dropless=dropless,
                                 grad_transform=grad_transform)
    fd_impl = None
    if flash_decode and mesh.shape.get("model", 1) > 1 and cfg.n_heads:
        from ..parallel.flash_decode import make_flash_decode
        fd_impl = make_flash_decode(mesh, "model")

    def prefill_step(params, batch, max_len: int):
        if cfg.family == "audio":          # an encoder: no cache to fill
            return M.forward(cfg, params, batch, moe_impl=moe_impl), None
        return M.prefill(cfg, params, batch, max_len, moe_impl=moe_impl)

    def decode_step(params, token, cache):
        return M.decode_step(cfg, params, token, cache, moe_impl=moe_impl,
                             flash_decode=fd_impl)

    return StepFns(train_step=train_step, prefill_step=prefill_step,
                   decode_step=decode_step, ep_cfg=ep,
                   dropless=train_step.dropless, rules=rules)
