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

On a process mesh (``launch.mesh.dist_mesh(dims)``, one rank a process)
the train step takes this rank's block of the batch and of the params
(``parallel.sharding.own_params``) and an optimizer state of the same
blocks, ZeRO-1's in zero1 and ep_dp (``adamw.init_opt_state(params,
rules, mesh)``):

* zero1 and ep_dp: the rank's rows of a batch split over every axis its
  spec names; the params replicated, but ep_dp's experts, which are the
  rank's own. Where the spec leaves ``model`` out (``global_batch`` too
  small for every rank: 256 rows on 2 x 16 x 16), each rank of a model
  group holds the group's rows, and the MoE routes the rank's sequence
  chunk of them (``parallel.ep.make_moe_ep(rows_repeat=True)``);
* tp_sp (every family; the MoE with ``ep=``): the rank's sequence chunk
  of its data group's rows (a vlm's patches whole, an audio encoder's
  frames chunked); its heads, vocabulary block, experts and MLP, SSM and
  RG-LRU channels over ``model`` and, with FSDP, its block of the layer
  matrices over ``data``, placed by an ambient
  ``parallel.tp.TensorParallel`` (``seq_parallel=False``: the residual
  replicated over ``model``). ``parallel.sharding.batch_block`` cuts a
  rank's block from a whole batch.

With ``dropless`` the train step's MoE is the dropless fragment there too:
each rank gathers the whole batch's tokens and experts and runs the
reference's fragment over all of them (``launch.dropless.MeshRows``). The
prefill and decode steps serve on the same blocks, each rank holding its
``cache_spec`` blocks of the cache (``make_steps``), their MoE EP's.

After the backward :func:`reduce_grads` sums each grad over the ranks that
hold other rows for its block and takes the mean over the batch's shares.
The loss is the mean over the ranks. Rows repeated over an axis are shares
all the same: each copy's loss is its rows' mean, and the collectives'
transposes are those of the sum of every rank's loss, so the sum over the
ranks is each distinct block's grad times its copies, as many for every
block.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..models import model as M
from ..optim import adamw
from ..parallel.ctx import cache_blocks_context, tensor_parallel_context
from ..parallel.ep import EPConfig, make_moe_ep
from ..parallel.sharding import ShardingRules, param_specs, spec_axes
from ..parallel.tp import TensorParallel
from .dropless import make_moe_dropless

MODES = ("tp_sp", "zero1", "ep_dp")


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


def reduce_grads(grads, mesh, rules):
    """The mean of the ranks' grads on a process mesh, in place: each leaf
    summed over the axes its param spec does not split (the ranks that
    hold other rows for its block: a leaf split over ``model`` got its
    group's sum from the collectives' transposes, EP's experts from the
    ring, an FSDP leaf its sum over ``data`` from the reduce-scatter), then
    divided by the batch's shares: every rank's rows in zero1 and ep_dp
    (rows repeated over an axis counted once a copy: see the module
    docstring), every data group's in tp_sp, whose ranks share one loss."""
    n = math.prod(mesh.shape.values())
    shares = n // (mesh.shape["model"] if rules.mode == "tp_sp" else 1)
    for g, spec in zip(adamw.tree_leaves(grads),
                       param_specs(rules, grads, own=True)):
        axes = tuple(a for a in mesh.axis_names if a not in spec_axes(spec)
                     and mesh.shape[a] > 1)
        if axes:
            g.copy_(mesh.axes_comm(axes).all_reduce(g))
        g.div_(shares)
    return grads


def make_train_step(cfg, opt: Optional[adamw.OptConfig] = None, *,
                    accum_steps: int = 0, moe_impl=None, mesh=None, ep=None,
                    dropless=None, grad_transform=None, rules=None,
                    seq_parallel: bool = True,
                    global_batch: Optional[int] = None):
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
    ``ssc_pad_ratio`` for the step; on a process mesh the fragment runs
    over the whole batch on every rank, and replaces ``ep``. ``ep``: an
    :class:`EPConfig` runs the MoE expert-parallel over ``mesh``'s model
    axis (a mesh of virtual ranks places nothing). ``grad_transform`` runs
    on the grads before the update (``adamw.apply_updates``). ``rules`` and a process ``mesh``: the step
    of this rank (see the module docstring); ``seq_parallel`` then places
    tp_sp's residual, and ``global_batch`` (the whole batch's rows; by
    default as many as split over every axis) decides whether zero1's and
    ep_dp's rows repeat over ``model``.
    """
    dist_step = rules is not None and mesh is not None and mesh.local_rows
    if rules is not None and not dist_step:
        raise ValueError("rules= places a step on a process mesh "
                         "(launch.mesh.dist_mesh(dims)); pass mesh= too")
    tp = None
    if dist_step and rules.mode == "tp_sp":
        tp = TensorParallel(mesh, rules, seq=seq_parallel)
    dropless_moe = None
    if dropless is not None and cfg.family == "moe":
        dropless_moe = make_moe_dropless(
            cfg, dropless, **({"mesh": mesh, "rules": rules,
                               "global_batch": global_batch}
                              if dist_step else {}))
    ep_moe = ep is not None and cfg.family == "moe"
    if ep_moe:
        if mesh is None:
            raise ValueError("ep= needs the mesh= whose model axis it runs on")
        repeat = (dist_step and rules.mode != "tp_sp"
                  and global_batch is not None and "model" not in spec_axes(
                      rules.batch_spec({"labels": (global_batch,)})
                      ["labels"]))
        moe_impl = make_moe_ep(mesh, ep, cfg.act, mode=(
            rules.mode if dist_step else "tp_sp"), rows_repeat=repeat)
    elif (dist_step and rules.mode != "zero1" and cfg.family == "moe"
          and dropless_moe is None):
        raise ValueError(f"{rules.mode} holds each rank's experts: pass ep=")
    if dropless_moe is not None:
        moe_impl = dropless_moe.impl
    opt = opt or adamw.OptConfig()
    if accum_steps == 0:
        # Default policy: microbatch the big archs so train activations fit
        # device memory (grad accumulation is the production lever here).
        n_params = cfg.param_count()
        accum_steps = 8 if n_params > 100e9 else (4 if n_params > 10e9 else 1)

    def loss_and_grads(params, batch):
        with tensor_parallel_context(tp):
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
            grads = reduce_grads(grads, mesh, rules)
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
               flash_decode: bool = True, seq_parallel: bool = True,
               fsdp: Optional[bool] = None,
               global_batch: Optional[int] = None) -> StepFns:
    """The train, prefill and decode steps over ``mesh``.

    ``fsdp`` (default: on above ``sharding.FSDP_THRESHOLD`` parameters) and
    ``seq_parallel`` are the reference's: on a process mesh in tp_sp they
    place the attention and expert matrices' ``d`` over ``data`` and the
    residual's sequence over ``model``; a mesh of virtual ranks computes
    the same values either way. ``global_batch``: the rows of the whole
    batch a process mesh's steps take their blocks of
    (``make_train_step``; by default as many as split over every axis the
    mode splits rows over).

    EP (``ep``) is the MoE of all three; ``dropless`` replaces it in
    training only, as in the reference. An audio encoder's prefill step is
    its forward, ``(logits, None)``. The decode step uses flash
    decoding when ``flash_decode`` is set, the mesh's model axis is larger
    than 1 and the config has heads; without it the dense one-token
    attention runs (on a process mesh over each layer's cache blocks
    all-gathered).

    On a process mesh the serving steps are this rank's:
    ``prefill_step(params, batch, max_len, prompt_len=None)`` and
    ``decode_step(params, token, cache, max_len=None)`` take the rank's
    params (``sharding.own_params``) and batch block
    (``sharding.batch_block``); the cache is the rank's ``cache_spec``
    blocks (``parallel.tp.CacheBlocks``; a spec naming an axis twice
    raises ``ValueError``, as the reference raises ``DuplicateSpecError``),
    made by the prefill. The logits come back whole on every rank (the
    reference's ``out_shardings=None``): every row, the whole vocabulary.
    In tp_sp the prefill keeps training's placement (the residual's
    sequence over ``model`` where the prompt splits) and a decode step
    replicates the residual over ``model``; in zero1 and ep_dp each rank
    runs its rows whole. ``prompt_len``: the prompt's whole length, by
    default the block's times the model axis in tp_sp (a prompt that the
    model axis does not split passes it); ``max_len``: the cache's, by
    default the last prefill's.
    """
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    rules = ShardingRules(cfg, mesh, fsdp=fsdp, mode=mode)
    if mode == "ep_dp" and ep is not None:
        ep = dataclasses.replace(ep, dp_batch=True)
    if mesh.local_rows:
        train_step = make_train_step(
            cfg, opt, accum_steps=accum_steps, mesh=mesh, ep=ep,
            dropless=dropless, grad_transform=grad_transform, rules=rules,
            seq_parallel=seq_parallel, global_batch=global_batch)
        prefill_step, decode_step = _dist_serving(
            cfg, mesh, rules, ep, flash_decode, seq_parallel, global_batch)
        return StepFns(train_step=train_step, prefill_step=prefill_step,
                       decode_step=decode_step, ep_cfg=ep,
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


def _dist_serving(cfg, mesh, rules, ep, flash_decode, seq_parallel,
                  global_batch):
    """The prefill and decode steps of this rank of a process mesh (see
    :func:`make_steps`)."""
    from ..parallel.flash_decode import make_flash_decode
    from ..parallel.sharding import block_shape
    from ..parallel.tp import CacheBlocks
    M_ = mesh.shape["model"]
    fd_impl = (make_flash_decode(mesh) if flash_decode and M_ > 1
               and cfg.n_heads else None)
    made: dict = {}
    last = {"max_len": None}

    def once(key, make):
        if key not in made:
            made[key] = make()
        return made[key]

    def rows(b: int) -> int:
        """The whole batch's rows: ``global_batch``, or a block of ``b``
        times every axis the mode may split rows over."""
        return global_batch or b * math.prod(
            n for a, n in mesh.shape.items()
            if rules.mode != "tp_sp" or a != "model")

    def moe(B: int):
        if ep is None or cfg.family != "moe":
            return None
        repeat = rules.mode != "tp_sp" and "model" not in spec_axes(
            rules.batch_spec({"labels": (B,)})["labels"])
        return once(("moe", B), lambda: make_moe_ep(
            mesh, ep, cfg.act, mode=rules.mode, rows_repeat=repeat))

    def tensor_parallel(seq: bool, split: bool):
        if rules.mode != "tp_sp":
            return None
        return once(("tp", seq, split), lambda: TensorParallel(
            mesh, rules, seq=seq, split_tokens=split))

    def whole_rows(logits, B: int):
        """The logits of every row, gathered over the batch spec's axes."""
        axes = spec_axes(rules.batch_spec({"labels": (B,)})["labels"])
        if not axes:
            return logits
        return mesh.axes_comm(axes).all_gather_dim(logits, 0)

    def run(B, max_len, tp, fn):
        cb = once(("cache", B, max_len),
                  lambda: CacheBlocks(mesh, rules, B, max_len))
        with torch.no_grad(), tensor_parallel_context(tp), \
                cache_blocks_context(cb):
            return fn(cb, moe(B))

    def prefill_step(params, batch, max_len: int,
                     prompt_len: Optional[int] = None):
        key = "features" if cfg.family == "audio" else "tokens"
        b, s = batch[key].shape[:2]
        B = rows(b)
        S = prompt_len or (s * M_ if rules.mode == "tp_sp" and M_ > 1
                           else s)
        whole = {k: (B, S) + tuple(v.shape[2:]) if k == key
                 else (B,) + tuple(v.shape[1:]) for k, v in batch.items()}
        want = {k: block_shape(v, rules.batch_spec(whole)[k], mesh)
                for k, v in whole.items()}
        got = {k: tuple(v.shape) for k, v in batch.items()}
        if got != want:
            raise ValueError(
                f"a batch of {B} rows x {S} positions splits into blocks "
                f"{want} on this mesh, not {got} (pass prompt_len= or "
                f"make_steps(global_batch=) for another split)")
        split = "model" in spec_axes(rules.batch_spec(whole)[key])
        tp = tensor_parallel(seq_parallel and split, split)
        last["max_len"] = max_len
        if cfg.family == "audio":      # an encoder: no cache to fill
            return run(B, max_len, tp, lambda cb, moe_impl: (whole_rows(
                M.forward(cfg, params, batch, moe_impl=moe_impl), B), None))

        def fill(cb, moe_impl):
            logits, cache = M.prefill(cfg, params, batch, max_len, moe_impl,
                                      cache=cb.alloc(batch[key].device))
            return whole_rows(logits, B), cache
        return run(B, max_len, tp, fill)

    def decode_step(params, token, cache, max_len: Optional[int] = None):
        max_len = max_len or last["max_len"]
        if max_len is None:
            raise ValueError("decode_step on a process mesh needs the "
                             "cache's max_len: pass max_len= or prefill "
                             "first")
        B = rows(token.shape[0])

        def step(_cb, moe_impl):
            logits, new = M.decode_step(cfg, params, token, cache, moe_impl,
                                        flash_decode=fd_impl)
            return whole_rows(logits, B), new
        return run(B, max_len, tensor_parallel(False, False), step)

    return prefill_step, decode_step
