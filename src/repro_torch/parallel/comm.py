"""Collectives over one mesh axis of ``ep`` ranks — what ``jax.shard_map``
gives the reference's EP and flash-decoding code (``repro.parallel.ep``,
``repro.parallel.flash_decode``).

A program written against this interface holds one list entry per rank that
this process runs (``comm.ranks``): every rank of the axis for
:class:`VirtualComm`, its own rank for :class:`DistComm`. Each collective
takes and returns such lists.

* ``shard(x, dim)`` / ``unshard(xs, dim)`` — the shard_map boundary: an
  input split along ``dim`` over the axis (``None``: replicated), and the
  output assembled the same way;
* ``all_to_all(xs)`` — ``jax.lax.all_to_all(x, split_axis=0,
  concat_axis=0, tiled=True)``: rank r's block s goes to rank s's block r;
* ``ppermute(xs, shift)`` — the ring's ``jax.lax.ppermute`` with the
  permutation ``i -> (i + shift) % ep``;
* ``pmax(xs)`` / ``psum(xs)`` — all-reduces, for flash decoding.

``VirtualComm`` runs the ranks' programs in turn in one process: each
collective reorders device tensors, so autograd runs through it as it
stands. ``DistComm`` runs one rank per process over a ``torch.distributed``
group (``gloo`` for CPU tensors, NCCL for CUDA tensors; a tensor on the
other kind of device raises). Its collectives are autograd functions whose
backward is the inverse transfer. Outside the boundary every process holds
the whole (replicated) tensors, as the reference's program outside
shard_map sees global arrays, and the boundary's backward follows
shard_map's transpose: a replicated input's grad is all-reduced over the
group, a replicated output's cotangent is divided by ``ep``, and a split
input or output is all-gathered or sliced.

Both count, in ``comm.stats``, the collectives of the program (not the
boundary) and the bytes one rank sends to other ranks: a block that stays
on its rank (the all-to-all's own block, the ring's step 0) is not link
traffic.
"""

from __future__ import annotations

import collections
import dataclasses

import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclasses.dataclass
class CommStats:
    """Collectives by kind (``all-to-all``, ``collective-permute``,
    ``all-reduce``) and the bytes one rank sent to other ranks."""
    counts: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    bytes: int = 0

    def add(self, kind: str, nbytes: int) -> None:
        self.counts[kind] += 1
        self.bytes += int(nbytes)

    def reset(self) -> None:
        self.counts.clear()
        self.bytes = 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _all_reduce_bytes(t, ep: int) -> int:
    """Bytes a rank sends in a ring all-reduce of ``t``."""
    return 2 * (ep - 1) * _nbytes(t) // ep


class VirtualComm:
    """The ``ep`` ranks of one axis in this process, on ``device``."""

    def __init__(self, ep: int, device="cuda"):
        if ep < 1:
            raise ValueError(f"ep must be >= 1, not {ep}")
        self.ep = ep
        self.device = resolve_device(device)
        self.ranks = list(range(ep))
        self.stats = CommStats()

    def shard(self, x, dim):
        if dim is None:
            return [x] * self.ep
        return list(torch.chunk(x, self.ep, dim))

    def unshard(self, xs, dim):
        # A replicated output: every rank computed the same values; rank 0's
        # copy carries the grads of all of them.
        return xs[0] if dim is None else torch.cat(xs, dim)

    def all_to_all(self, xs):
        self.stats.add("all-to-all", (self.ep - 1) * _nbytes(xs[0][0]))
        return [torch.stack([xs[s][r] for s in range(self.ep)])
                for r in range(self.ep)]

    def ppermute(self, xs, shift: int):
        if shift % self.ep:
            self.stats.add("collective-permute", _nbytes(xs[0]))
        return [xs[(r - shift) % self.ep] for r in range(self.ep)]

    def _reduce(self, xs, fn):
        self.stats.add("all-reduce", _all_reduce_bytes(xs[0], self.ep))
        out = fn(torch.stack(xs), 0)
        return [out] * self.ep

    def pmax(self, xs):
        return self._reduce(xs, torch.amax)

    def psum(self, xs):
        return self._reduce(xs, torch.sum)


class DistComm:
    """This process's rank of a ``torch.distributed`` group (default: the
    world)."""

    def __init__(self, group=None):
        if not dist.is_initialized():
            raise RuntimeError("DistComm needs torch.distributed."
                               "init_process_group first")
        self.group = group
        self.rank = dist.get_rank(group)
        self.ep = dist.get_world_size(group)
        self.backend = dist.get_backend(group)
        self.ranks = [self.rank]
        self.stats = CommStats()

    def _check(self, t: torch.Tensor) -> torch.Tensor:
        want = "nccl" if t.is_cuda else "gloo"
        if self.backend != want:
            raise RuntimeError(
                f"a {t.device.type} tensor needs a {want} group, not "
                f"{self.backend}")
        return t.contiguous()

    def _peer(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(
            self.group, r)

    # Raw transfers (no autograd, not counted).
    def _a2a(self, x):
        x = self._check(x)
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        return out

    def _shift(self, x, shift: int):
        x = self._check(x)
        dst, src = (self.rank + shift) % self.ep, (self.rank - shift) % self.ep
        if dst == self.rank:
            return x.clone()
        out = torch.empty_like(x)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, self._peer(dst), self.group),
            dist.P2POp(dist.irecv, out, self._peer(src), self.group)])
        for req in reqs:
            req.wait()
        return out

    def _gather(self, x, dim):
        x = self._check(x)
        parts = [torch.empty_like(x) for _ in range(self.ep)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim)

    def _all_reduce(self, x, op):
        x = self._check(x).clone()
        dist.all_reduce(x, op=op, group=self.group)
        return x

    def _own(self, x, dim):
        return torch.chunk(x, self.ep, dim)[self.rank]

    # The program's interface.
    def shard(self, x, dim):
        if dim is None:
            return [_ReduceGrad.apply(x, self)]
        return [_Slice.apply(x, self, dim)]

    def unshard(self, xs, dim):
        if dim is None:
            return _ScaleGrad.apply(xs[0], 1.0 / self.ep)
        return _Gather.apply(xs[0], self, dim)

    def all_to_all(self, xs):
        self.stats.add("all-to-all", (self.ep - 1) * _nbytes(xs[0][0]))
        return [_AllToAll.apply(xs[0], self)]

    def ppermute(self, xs, shift: int):
        if shift % self.ep:
            self.stats.add("collective-permute", _nbytes(xs[0]))
        return [_PPermute.apply(xs[0], self, shift)]

    def pmax(self, xs):
        self.stats.add("all-reduce", _all_reduce_bytes(xs[0], self.ep))
        return [self._all_reduce(xs[0], dist.ReduceOp.MAX)]

    def psum(self, xs):
        self.stats.add("all-reduce", _all_reduce_bytes(xs[0], self.ep))
        return [self._all_reduce(xs[0], dist.ReduceOp.SUM)]


class _AllToAll(torch.autograd.Function):
    """Blocks exchanged along dim 0; the exchange is its own inverse."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm._a2a(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm._a2a(g), None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, shift):
        ctx.comm, ctx.shift = comm, shift
        return comm._shift(x, shift)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm._shift(g, -ctx.shift), None, None


class _Slice(torch.autograd.Function):
    """Boundary entry of a split input: this rank's block; the grad of the
    whole tensor is the blocks' grads gathered."""

    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm._own(x, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.comm._gather(g, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    """Boundary exit of a split output: the blocks gathered; every process
    holds the same cotangent, of which this rank's block is its own."""

    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm._gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm._own(g, ctx.dim).contiguous(), None, None


class _ReduceGrad(torch.autograd.Function):
    """Boundary entry of a replicated input: its grad is summed over the
    group."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm._all_reduce(g, dist.ReduceOp.SUM), None


class _ScaleGrad(torch.autograd.Function):
    """Boundary exit of a replicated output: every rank computed it, so
    each takes 1/ep of the cotangent."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None
