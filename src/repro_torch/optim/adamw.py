"""AdamW with cosine schedule, global-norm clipping and grad accumulation —
counterpart of ``repro.optim.adamw``.

Parameter trees are nested dicts and lists of tensors (the port's params).
State mirrors the JAX state: fp32 ``m``/``v`` moments and fp32 ``master``
weights of the same tree, and an int ``step``.

Unlike the pure JAX functions, :func:`apply_updates` works in place: it
scales the grads, updates ``m``, ``v`` and ``master`` and copies the new
masters into ``params``, one tensor at a time. At granite's 3.98 B parameters
that keeps the temporaries to two fp32 copies of the largest tensor instead
of new trees the size of the whole model.

Weight decay follows the reference's result: JAX decays the leaves with
``ndim >= 2``, and its tree stacks the layers to ``[L, ...]``, so every
per-layer leaf is decayed, the norm scales (``[L, d]``) too. The port keeps
one tensor per layer (``params["blocks"]`` is a list), so it decays each leaf
whose JAX counterpart has ``ndim >= 2`` (:func:`decay_flags`): every matrix,
and every per-layer leaf of at least one dimension. A top-level 1-d leaf,
such as the final norm scale, is not decayed. A hybrid stack follows its
JAX layout: a 1-d leaf of a ``super`` layer (stacked over the super-blocks
there) is decayed, the same leaf of a ``tail`` layer (unstacked) is not.

A process mesh (``launch.mesh.dist_mesh(dims)``):
``init_opt_state(params, rules, mesh)`` keeps ``m``, ``v`` and ``master``
as this rank's block of each leaf under ``rules.opt_state_spec``
(``parallel.sharding``): ZeRO-1's in the zero1 and ep_dp modes, the param's
own block in tp_sp. ``apply_updates(..., rules=, mesh=)`` updates only
that block, then all-gathers the new param blocks over the axes the state
spec adds to the param's (none in tp_sp). AdamW is elementwise, so each
block's values are bit-equal to the same elements of the replicated update
of the same grads. The clip norm is that of the reduced grads: the same on
every rank. A leaf whose param is itself a block (ep_dp's experts, tp_sp's
split leaves) adds its blocks' squared sums over the ranks that hold the
others.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from ..parallel import sharding as S


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def tree_leaves(tree) -> list:
    """The tensors of a tree of dicts (in sorted-key order, as JAX flattens
    them) and lists."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, in :func:`tree_leaves` order, keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def schedule(oc: OptConfig, step: int) -> float:
    """Learning rate at ``step``: linear warm-up, then cosine to
    ``min_lr_frac``. Computed in fp32, as the JAX function is."""
    f32 = torch.float32
    s = torch.tensor(float(step), dtype=f32)
    warm = s / max(1.0, oc.warmup_steps)
    prog = (s - oc.warmup_steps) / max(1.0, oc.total_steps - oc.warmup_steps)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = oc.min_lr_frac + (1 - oc.min_lr_frac) * 0.5 * (
        1 + torch.cos(torch.tensor(math.pi, dtype=f32) * prog))
    return float(oc.lr * (warm if step < oc.warmup_steps else cos))


def cast_params(params, dtype=torch.bfloat16):
    """Compute-precision copy of the parameter tree (float leaves only)."""
    return tree_map(lambda p: p.to(dtype) if p.is_floating_point() else p,
                    params)


class Zero1:
    """This rank's share of a param tree's optimizer state over a process
    ``mesh`` (ZeRO-1's in zero1 and ep_dp; in tp_sp the param's own
    blocks): per leaf (``tree_leaves`` order) its param spec, its
    optimizer-state spec, and the state's spec relative to the param this
    rank holds."""

    def __init__(self, rules, mesh, params):
        self.mesh = mesh
        self.param_specs = S.param_specs(rules, params, own=True)
        self.opt_specs = S.opt_state_specs(rules, params, own=True)
        self.rel_specs = [S.relative_spec(o, p) for o, p in
                          zip(self.opt_specs, self.param_specs)]

    def block(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """Leaf ``i``'s state block (a view) of this rank's param-shaped
        ``t``."""
        return S.local_block(t, self.rel_specs[i], self.mesh.shape,
                             self.mesh.coords)

    def gather(self, i: int, blk: torch.Tensor) -> torch.Tensor:
        """This rank's param-shaped tensor from its block ``blk``: the
        blocks all-gathered over the axes the state spec adds."""
        spec = self.rel_specs[i]
        axes = S.spec_axes(spec)
        if not axes:
            return blk
        parts = self.mesh.axes_comm(axes).all_gather(blk.contiguous())
        sub = {a: self.mesh.shape[a] for a in self.mesh.axis_names
               if a in axes}
        return S.assemble(parts, spec, sub)

    def sharded_axes(self, i: int) -> tuple:
        """The axes over which leaf ``i``'s param is itself split, in the
        mesh's order."""
        axes = S.spec_axes(self.param_specs[i])
        return tuple(a for a in self.mesh.axis_names if a in axes)


def init_opt_state(params, rules=None, mesh=None) -> dict:
    """m/v moments + fp32 master weights (params at the step boundary are
    the compute copies; masters only appear in the update math).

    ``rules`` and a process ``mesh``: ZeRO-1, each of ``m``, ``v``,
    ``master`` the block of its leaf under ``rules.opt_state_spec`` at the
    mesh's ``coords`` (this rank's); ``params`` are those this rank
    holds."""
    blocks = None
    if rules is not None:
        z = Zero1(rules, mesh, params)
        it = iter(range(len(tree_leaves(params))))
        blocks = tree_map(lambda p: z.block(next(it), p), params)
    src = params if blocks is None else blocks

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(zeros, src),
            "v": tree_map(zeros, src),
            "master": tree_map(
                lambda p: p.detach().to(torch.float32, copy=True)
                .contiguous(), src),
            "step": 0}


def decay_flags(params) -> list:
    """Per leaf of ``params``, in :func:`tree_leaves` order: whether AdamW
    decays it, i.e. whether its JAX counterpart has ``ndim >= 2``. Leaves
    under ``params["blocks"]`` and ``params["super"]`` count one more
    dimension, the layer axis the JAX tree stacks them on; those under
    ``params["tail"]`` are unstacked in JAX too."""
    return [t.dim() + (k in ("blocks", "super")) >= 2
            for k in sorted(params) for t in tree_leaves(params[k])]


@torch.no_grad()
def apply_updates(params, grads, state, oc: OptConfig,
                  grad_transform: Optional[Callable] = None, *,
                  rules=None, mesh=None):
    """One AdamW step on the fp32 masters; refreshes the compute params.

    Returns ``(params, state, metrics)``. ``params``, ``grads`` and the
    tensors of ``state`` are updated in place (see the module docstring);
    ``state["step"]`` is a new int. ``grad_transform(grads) -> grads`` runs
    before clipping (``parallel.compression``'s transforms). ``metrics``:
    ``grad_norm`` (before clipping), ``grad_leaf_norms`` (each leaf's, in
    ``tree_leaves`` order) and ``lr``.

    ``rules`` and a process ``mesh``: the ZeRO-1 update of a state from
    ``init_opt_state(params, rules, mesh)``, the grads already reduced.
    """
    if grad_transform is not None:
        grads = grad_transform(grads)
    gl = tree_leaves(grads)
    zero = None if rules is None else Zero1(rules, mesh, params)
    # Each leaf's squares summed in fp64: a leaf's blocks summed apart and
    # added give its sum to well under an fp32 ulp, so the norm, and so the
    # update, does not depend on how the leaf is split. The fp64 norm
    # kernel squares and sums the leaf's one fp64 copy in one pass.
    sq = [torch.linalg.vector_norm(g, dtype=torch.float64).square()
          for g in gl]
    if zero is not None:
        # A leaf split over some axes sums its blocks' squares over them.
        by_axes: dict = {}
        for i in range(len(gl)):
            axes = zero.sharded_axes(i)
            if axes:
                by_axes.setdefault(axes, []).append(i)
        for axes, idx in by_axes.items():
            tot = mesh.axes_comm(axes).all_reduce(torch.stack(
                [sq[i] for i in idx]))
            for j, i in enumerate(idx):
                sq[i] = tot[j]
    total = torch.zeros((), dtype=torch.float64, device=gl[0].device)
    for v in sq:
        total = total + v
    gnorm = torch.sqrt(total).float()
    scale = torch.clamp(oc.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state["step"] + 1
    lr = schedule(oc, step)
    b1, b2 = oc.betas
    bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** step)
    bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** step)
    for i, (p, g, m, v, master, decay) in enumerate(zip(
            tree_leaves(params), gl, tree_leaves(state["m"]),
            tree_leaves(state["v"]), tree_leaves(state["master"]),
            decay_flags(params))):
        if zero is not None:
            g = zero.block(i, g)
        g = g.mul_(scale.to(g.dtype)).float()
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(oc.eps))
        if decay:                     # decoupled weight decay
            delta.add_(master, alpha=oc.weight_decay)
        master.add_(delta, alpha=-lr)
        if zero is None:
            p.copy_(master)
        else:
            p.copy_(zero.gather(i, master.to(p.dtype)))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr,
                           "grad_leaf_norms": torch.sqrt(
                               torch.stack(sq)).float()}


def accumulate_grads(loss_and_grad_fn, params, microbatches):
    """Microbatch gradient accumulation: the mean loss and the mean fp32
    grads of ``loss_and_grad_fn(params, mb)``.

    ``microbatches``: a tree of tensors with a leading [n_micro] dim; a
    Python loop over it replaces the JAX scan.
    """
    n = tree_leaves(microbatches)[0].shape[0]
    acc, total = None, 0.0
    for i in range(n):
        loss, grads = loss_and_grad_fn(
            params, tree_map(lambda a, i=i: a[i], microbatches))
        if acc is None:
            acc = tree_map(lambda g: g.float(), grads)
        else:
            tree_map(lambda a, g: a.add_(g.float()), acc, grads)
        total = total + loss
    return total / n, tree_map(lambda g: g / n, acc)
