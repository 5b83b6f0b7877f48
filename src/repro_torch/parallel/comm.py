"""Collectives over one mesh axis of ``ep`` ranks — what ``jax.shard_map``
gives the reference's EP and flash-decoding code (``repro.parallel.ep``,
``repro.parallel.flash_decode``).

A program written against this interface holds one list entry per rank that
this process runs (``comm.ranks``): every rank of the axis for
:class:`VirtualComm`, its own rank for :class:`DistComm`. Each collective
takes and returns such lists.

* ``shard(x, dim)`` / ``unshard(xs, dim)`` (:class:`VirtualComm` only) —
  the shard_map boundary: an input split along ``dim`` over the axis
  (``None``: replicated), and the output assembled the same way;
* ``all_to_all(xs)`` — ``jax.lax.all_to_all(x, split_axis=0,
  concat_axis=0, tiled=True)``: rank r's block s goes to rank s's block r;
* ``ppermute(xs, shift)`` — the ring's ``jax.lax.ppermute`` with the
  permutation ``i -> (i + shift) % ep``;
* ``pmax(xs)`` / ``psum(xs)`` — all-reduces, for flash decoding.

``VirtualComm`` runs the ranks' programs in turn in one process: each
collective reorders device tensors, so autograd runs through it as it
stands. ``DistComm`` runs one rank per process over a ``torch.distributed``
group: NCCL for CUDA tensors, ``gloo`` for CPU tensors. A CUDA tensor on a
``gloo`` group (the launcher's ``--backend gloo``) is staged: each transfer
copies it to a host buffer, moves that, and copies the result back, its
counted bytes unchanged. That is how one card runs several processes,
which NCCL refuses. A CPU tensor on an NCCL group raises. Its collectives
are autograd functions whose backward is the transfer's transpose.

A ``DistComm`` process holds its own rows and blocks (a process mesh,
``launch.mesh.dist_mesh(dims)``): ``parallel.ep`` hands the program those
rows as they are. For tensor and sequence parallelism (``parallel.tp``)
and FSDP it also has the collectives of a layer, each an autograd function
with its transpose:

* ``all_gather_dim(x, dim)`` — every rank's block concatenated along
  ``dim``; the backward reduce-scatters;
* ``reduce_scatter_dim(x, dim)`` — this rank's block along ``dim`` of the
  sum of every rank's ``x``; the backward all-gathers;
* ``all_reduce_sum(x, partial_grads)`` — the sum of every rank's ``x``;
  the backward is the identity, or with ``partial_grads`` an all-reduce.

A tensor that every rank of the axis holds whole (a replicated residual,
an all-gather's result) carries a partial share of its cotangent on each
rank: the ranks' shares sum to it, as each rank's heads or vocabulary
block adds its part of the grad. That is why the all-gather transposes to
a reduce-scatter, and why the sum of a replicated tensor's partial values
(the row-parallel output without sequence parallelism) transposes to an
all-reduce. A sum that every rank consumes alike (the cross entropy's
vocabulary statistics, under a loss that every rank seeds whole) has the
whole cotangent on every rank, and transposes to the identity.

Both count, in ``comm.stats``, the collectives of the forward program (a
recompute's included; a backward's transfers, the transposes, are not
counted) and the bytes one rank sends to other ranks: a block that stays
on its rank (the all-to-all's own block, the ring's step 0) is not link
traffic. ``DistComm`` and :class:`CountingComm` also count every transfer
they make, by kind and bytes sent, in ``stats.transfers`` and
``stats.transfer_bytes``: the forward's, a recompute's, the backward's
transposes and the data-parallel and ZeRO-1 ones alike, what the dry run
prices (``launch/dryrun.py``). ``DistComm`` also counts the data-parallel
``all_reduce`` and the ZeRO-1 ``all_gather``; its ``gather``,
``broadcast_object`` and ``all_gather_object`` (a checkpoint's and the
loop's bookkeeping) are not counted. On a ``gloo`` group, whose transfers end on the host, it also
adds each transfer's host seconds to ``stats.seconds`` by kind, the
backward's transfers included; an NCCL transfer is asynchronous, and is
not timed.

:class:`CountingComm` is a ``DistComm`` without ``torch.distributed``: one
rank of a counting process mesh (``launch.mesh.counting_mesh``,
``make_production_mesh``) whose transfers move nothing. Each returns a
new tensor of the shape the real transfer gives, on the input's device
(the meta device, where the dry run counts one rank's program), and counts
itself as ``DistComm`` does.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclasses.dataclass
class CommStats:
    """Collectives by kind (``all-to-all``, ``collective-permute``,
    ``all-reduce``, ``all-gather``, ``reduce-scatter``) and the bytes one rank sent to other ranks; a
    ``DistComm`` over gloo adds its transfers' host seconds by kind."""
    counts: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    bytes: int = 0
    seconds: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    # Every transfer of a DistComm or CountingComm, the backward's
    # included: count and bytes sent by kind.
    transfers: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    transfer_bytes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    def add(self, kind: str, nbytes: int) -> None:
        self.counts[kind] += 1
        self.bytes += int(nbytes)

    def moved(self, kind: str, nbytes: int) -> None:
        self.transfers[kind] += 1
        self.transfer_bytes[kind] += int(nbytes)

    def reset(self) -> None:
        self.counts.clear()
        self.bytes = 0
        self.seconds.clear()
        self.transfers.clear()
        self.transfer_bytes.clear()


# ``reduce_scatter_single`` is the newer name of ``reduce_scatter_tensor``.
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or getattr(
    dist, "reduce_scatter_tensor")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _all_reduce_bytes(t, ep: int) -> int:
    """Bytes a rank sends in a ring all-reduce of ``t``."""
    return 2 * (ep - 1) * _nbytes(t) // ep


# Bytes a rank sends in one raw transfer of its tensor ``t`` over ``ep``
# ranks, by kind: the all-to-all's and the reduce-scatter's ``t`` holds
# every rank's block, the all-gather's is this rank's.
_SENT = {"all-to-all": lambda t, ep: (ep - 1) * _nbytes(t) // ep,
         "collective-permute": lambda t, ep: _nbytes(t),
         "all-gather": lambda t, ep: (ep - 1) * _nbytes(t),
         "all-reduce": _all_reduce_bytes,
         "reduce-scatter": lambda t, ep: (ep - 1) * _nbytes(t) // ep}


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
    world). ``stats``: a :class:`CommStats` to share with other comms."""

    def __init__(self, group=None, *, stats=None):
        if not dist.is_initialized():
            raise RuntimeError("DistComm needs torch.distributed."
                               "init_process_group first")
        self.group = group
        self.rank = dist.get_rank(group)
        self.ep = dist.get_world_size(group)
        self.backend = dist.get_backend(group)
        self.ranks = [self.rank]
        self.stats = CommStats() if stats is None else stats

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor the backend moves: ``t``, or over gloo a CUDA
        tensor's copy in pinned host memory."""
        if self.backend == "nccl" and not t.is_cuda:
            raise RuntimeError(f"a {t.device.type} tensor needs a gloo "
                               f"group, not nccl")
        t = t.contiguous()
        if not (t.is_cuda and self.backend == "gloo"):
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t)

    @contextlib.contextmanager
    def _timed(self, kind: str, x: torch.Tensor):
        """Adds the transfer's host seconds to ``stats.seconds[kind]`` over
        gloo. The card first ends the work queued before the transfer,
        which the staged copy to the host would wait for all the same."""
        if self.backend != "gloo":
            yield
            return
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        t = time.perf_counter()
        try:
            yield
        finally:
            self.stats.seconds[kind] += time.perf_counter() - t

    def _peer(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(
            self.group, r)

    # Raw transfers (no autograd; each counted in ``stats.transfers`` and
    # timed over gloo).
    def _moved(self, kind: str, x) -> None:
        self.stats.moved(kind, _SENT[kind](x, self.ep))

    def _a2a(self, x):
        self._moved("all-to-all", x)
        with self._timed("all-to-all", x):
            w = self._wire(x)
            out = torch.empty_like(w)
            dist.all_to_all_single(out, w, group=self.group)
            return out.to(x.device)

    def _shift(self, x, shift: int):
        dst, src = (self.rank + shift) % self.ep, (self.rank - shift) % self.ep
        if dst == self.rank:
            return x.contiguous().clone()
        self._moved("collective-permute", x)
        with self._timed("collective-permute", x):
            w = self._wire(x)
            out = torch.empty_like(w)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, w, self._peer(dst), self.group),
                dist.P2POp(dist.irecv, out, self._peer(src), self.group)])
            for req in reqs:
                req.wait()
            return out.to(x.device)

    def _blocks(self, x) -> list:
        """Every rank's ``x`` (equal shapes), in rank order."""
        self._moved("all-gather", x)
        with self._timed("all-gather", x):
            w = self._wire(x)
            parts = [torch.empty_like(w) for _ in range(self.ep)]
            dist.all_gather(parts, w, group=self.group)
            return [p.to(x.device) for p in parts]

    def _gather(self, x, dim):
        return torch.cat(self._blocks(x), dim)

    def _all_reduce(self, x, op):
        self._moved("all-reduce", x)
        with self._timed("all-reduce", x):
            w = self._wire(x)
            w = w.clone() if w is x else w
            dist.all_reduce(w, op=op, group=self.group)
            return w.to(x.device)

    def _scatter(self, x, dim):
        """This rank's block along ``dim`` of the sum of every rank's
        ``x`` (equal shapes)."""
        self._moved("reduce-scatter", x)
        with self._timed("reduce-scatter", x):
            w = self._wire(x.movedim(dim, 0))
            out = torch.empty((w.shape[0] // self.ep,) + tuple(w.shape[1:]),
                              dtype=w.dtype, device=w.device,
                              pin_memory=w.device.type == "cpu"
                              and w.is_pinned())
            _reduce_scatter(out, w, group=self.group)
            return out.to(x.device).movedim(0, dim)

    # The program's interface.
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

    # Tensor and sequence parallelism, FSDP (counted; autograd functions).
    def all_gather_dim(self, x, dim: int):
        """Every rank's ``x`` (equal shapes) concatenated along ``dim`` in
        rank order; the backward reduce-scatters the cotangents."""
        if self.ep == 1:
            return x
        self.stats.add("all-gather", (self.ep - 1) * _nbytes(x))
        return _AllGatherDim.apply(x, self, dim)

    def reduce_scatter_dim(self, x, dim: int):
        """This rank's block along ``dim`` of the sum of every rank's
        ``x``; the backward all-gathers the cotangents."""
        if self.ep == 1:
            return x
        if x.shape[dim] % self.ep:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"split over {self.ep} ranks")
        self.stats.add("reduce-scatter",
                       (self.ep - 1) * _nbytes(x) // self.ep)
        return _ReduceScatterDim.apply(x, self, dim)

    def all_reduce_sum(self, x, partial_grads: bool):
        """The sum of every rank's ``x``. ``partial_grads``: each rank
        holds a partial share of the sum's cotangent, and the backward
        all-reduces them; else every rank holds the whole one, and the
        backward is the identity."""
        if self.ep == 1:
            return x
        self.stats.add("all-reduce", _all_reduce_bytes(x, self.ep))
        return _AllReduceSum.apply(x, self, partial_grads)

    # Data parallelism and ZeRO-1 (counted; no autograd).
    def all_reduce(self, x):
        """The sum of every rank's ``x``, a new tensor."""
        if self.ep == 1:
            return x.clone()
        self.stats.add("all-reduce", _all_reduce_bytes(x, self.ep))
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def all_gather(self, x) -> list:
        """Every rank's ``x`` (equal shapes), in rank order."""
        if self.ep == 1:
            return [x]
        self.stats.add("all-gather", (self.ep - 1) * _nbytes(x))
        return self._blocks(x)

    # Bookkeeping (not counted).
    def gather(self, x, dst: int = 0):
        """Every rank's ``x`` (equal shapes) on the host of rank ``dst``,
        in rank order; ``None`` on the other ranks."""
        w = self._wire(x)
        parts = ([torch.empty_like(w) for _ in range(self.ep)]
                 if self.rank == dst else None)
        dist.gather(w, parts, dst=self._peer(dst), group=self.group)
        return None if parts is None else [p.cpu() for p in parts]

    def broadcast_object(self, obj, src: int = 0):
        """Rank ``src``'s ``obj`` (picklable) on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=self._peer(src),
                                   group=self.group)
        return box[0]

    def all_gather_object(self, obj) -> list:
        out = [None] * self.ep
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def _received(x, shape=None):
    """A counted transfer's result: a new tensor that the work counter
    sees written (``parallel.roofline``)."""
    return torch.zeros(x.shape if shape is None else shape, dtype=x.dtype,
                       device=x.device)


class CountingComm(DistComm):
    """Rank ``rank`` of a group of ``ep`` that moves nothing: each transfer
    counts itself and returns a new tensor of its result's shape on the
    input's device (zeros; the meta device's hold no values). The
    collectives, their autograd functions and their counts are
    ``DistComm``'s; its bookkeeping (``gather``, ``barrier``, ...) is not
    counted and needs ``torch.distributed``. ``stats``: a
    :class:`CommStats` to share with other comms."""

    def __init__(self, ep: int, rank: int = 0, *, stats=None):
        if not 0 <= rank < ep:
            raise ValueError(f"rank {rank} of a group of {ep}")
        self.group, self.backend = None, "counting"
        self.rank, self.ep = rank, ep
        self.ranks = [rank]
        self.stats = CommStats() if stats is None else stats

    def _a2a(self, x):
        self._moved("all-to-all", x)
        return _received(x)

    def _shift(self, x, shift: int):
        if shift % self.ep == 0:
            return x.contiguous().clone()
        self._moved("collective-permute", x)
        return _received(x)

    def _blocks(self, x) -> list:
        self._moved("all-gather", x)
        return [_received(x) for _ in range(self.ep)]

    def _all_reduce(self, x, op):
        self._moved("all-reduce", x)
        return _received(x)

    def _scatter(self, x, dim):
        self._moved("reduce-scatter", x)
        shape = list(x.shape)
        shape[dim] //= self.ep
        return _received(x, shape)


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


class _AllGatherDim(torch.autograd.Function):
    """The ranks' blocks along ``dim``; the whole's cotangent is the sum of
    the ranks' shares, of which this rank's block is its own."""

    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm._gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm._scatter(g, ctx.dim), None, None


class _ReduceScatterDim(torch.autograd.Function):
    """This rank's block of the ranks' sum; each addend's cotangent is the
    whole sum's, the blocks' cotangents gathered."""

    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm._scatter(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm._gather(g, ctx.dim), None, None


class _AllReduceSum(torch.autograd.Function):
    """The ranks' sum; each addend's cotangent is the sum's: the ranks'
    shares of it all-reduced, or the one every rank holds."""

    @staticmethod
    def forward(ctx, x, comm, partial_grads):
        ctx.comm, ctx.partial = comm, partial_grads
        return comm._all_reduce(x, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = ctx.comm._all_reduce(g, dist.ReduceOp.SUM)
        return g, None, None
