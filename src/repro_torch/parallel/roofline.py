"""Roofline terms of one step, counted in PyTorch and priced on an H100 —
counterpart of ``repro.parallel.roofline``.

The reference reads a compiled step's FLOPs and bytes from XLA's cost
analysis and prices them on a TPU v5e. The port runs eagerly, so
:class:`WorkCounter`, a ``TorchDispatchMode``, counts the aten ops of a step
while it runs, on the meta device in ``launch/dryrun.py``:

* FLOPs by ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, attention); elementwise ops count none;
* bytes: each op's input and output tensors (a broadcast input at most
  its storage's bytes). The port runs one kernel an op, so this is the
  traffic the card sees, less what its caches keep. Views and ``empty``
  move nothing; an in-place scatter (``index_put_``,
  ``index_copy_``, ...) moves its values and indices, read and written, not
  its whole target; a fill or copy does not read its target;
* the grouped-GEMM kernels: on meta each wrapper reports its kernel's own
  work (``kernels/work.py``) and runs nothing, so the count is the kernel's,
  not its plain version's;
* peak live bytes: the storages a step's ops allocate, each released by a
  weakref finalizer when it dies, over the step. It stands in for XLA's
  ``temp`` bytes; what lives before the step (params, optimizer state,
  batch, cache) is the argument bytes.

The reference parses collectives from HLO text (``parse_collectives``); the
port has no HLO and no counterpart. An EP cell's collective bytes come from
``parallel/comm.py``'s counters (``comm.stats``), and they are 0 on one
card, the only mesh the dry run runs on. ``t_compute`` divides by the peak
of the config's compute dtype (``core.hardware.H100``).
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..core.hardware import H100
from ..optim.adamw import tree_leaves

# Ops that move no bytes: aliases, and allocations that write nothing.
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh",
         "_unsafe_view", "_reshape_alias", "set_"}
# In-place scatters: the values and indices are read and the touched rows
# written; the rest of the target is not moved.
_SCATTER = {"index_put_", "_index_put_impl_", "index_copy_", "index_add_",
            "scatter_", "scatter_add_", "scatter_reduce_",
            "masked_scatter_"}
# In-place writes that do not read their target.
_WRITE_ONLY = {"copy_", "fill_", "zero_", "normal_", "uniform_", "random_",
               "bernoulli_", "exponential_"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _read_bytes(t) -> int:
    """An input's bytes: its elements', or its storage's where that is
    less (a broadcast view reads each stored element once)."""
    return min(_nbytes(t), t.untyped_storage().nbytes())


def _tensors(items) -> list:
    """The tensors of an op's arguments or results: top level, or in a
    list or tuple (``cat``'s inputs, ``index_put_``'s indices)."""
    out = []
    for a in items:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out += [t for t in a if isinstance(t, torch.Tensor)]
    return out


def _op_info(func) -> tuple:
    """(name, moves no bytes, mutates an argument, FLOP formula or None)."""
    packet = func._overloadpacket
    name = packet.__name__
    return (name, func.is_view or name in _FREE, func._schema.is_mutable,
            flop_registry.get(packet))


class WorkCounter(TorchDispatchMode):
    """Counts the FLOPs, bytes and peak live bytes of the aten ops run
    under it (``with WorkCounter() as wc: ...``), on any device: a step
    counts the same on the meta device as on the CPU."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.kernels: dict = {}     # name -> {"calls", "bytes", "flops"}
        self.live_bytes = 0         # allocated under the counter, alive
        self.peak_live_bytes = 0
        self._live: set = set()
        self._info: dict = {}       # op -> _op_info(op)

    def record_kernel(self, name: str, nbytes: int, n_ops: int) -> None:
        """A kernel call's own work (``kernels.work.record``)."""
        k = self.kernels.setdefault(name, {"calls": 0, "bytes": 0,
                                           "flops": 0})
        k["calls"] += 1
        k["bytes"] += nbytes
        k["flops"] += n_ops
        self.bytes += nbytes
        self.flops += n_ops

    def _release(self, key: int, nbytes: int) -> None:
        self._live.discard(key)
        self.live_bytes -= nbytes

    @staticmethod
    def _op_bytes(name: str, args, ins, outs) -> int:
        if name in _SCATTER or name in _WRITE_ONLY:
            target = args[0] if args else None
            rest = sum(_read_bytes(t) for t in ins if t is not target)
            if name in _SCATTER:
                return 2 * rest
            return rest + sum(_nbytes(t) for t in outs)
        return (sum(_read_bytes(t) for t in ins)
                + sum(_nbytes(t) for t in outs))

    def _track(self, ins, outs) -> None:
        """Count each output storage that no input holds and that is not
        already counted as a new allocation."""
        held = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in held or key in self._live:
                continue
            n = st.nbytes()
            self._live.add(key)
            self.live_bytes += n
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
            weakref.finalize(st, self._release, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        info = self._info.get(func)
        if info is None:
            info = self._info[func] = _op_info(func)
        name, free, mutable, flop_fn = info
        ins = _tensors(args) + _tensors(kwargs.values())
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        self.ops += 1
        if flop_fn is not None:
            self.flops += flop_fn(*args, **kwargs, out_val=out)
        if not free:
            self.bytes += self._op_bytes(name, args, ins, outs)
            if not mutable:
                self._track(ins, outs)
        return out


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages of a tree's tensors."""
    seen, total = set(), 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                total += st.nbytes()
    return total


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    model_flops_global: float
    arg_bytes: float
    temp_bytes: float
    coll_counts: dict
    # Minimal HBM traffic (params + caches + optimizer state for train),
    # global across chips: the memory side's analogue of 6ND.
    model_bytes_global: float = 0.0
    dtype: str = "bfloat16"       # the compute dtype, whose peak it uses
    kernels: dict = dataclasses.field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / H100.peak_flops(self.dtype)

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / H100.hbm_bytes_per_s

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / H100.nvlink_bytes_per_s

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        counted = self.flops_per_device * self.chips
        return self.model_flops_global / max(1.0, counted)

    @property
    def useful_bytes_ratio(self) -> float:
        counted = self.bytes_per_device * self.chips
        return self.model_bytes_global / max(1.0, counted)

    @property
    def roofline_frac(self) -> float:
        """max(useful-compute, useful-bandwidth) time / dominant bound: how
        close the counted step is to the least work on either roofline."""
        bound = max(self.t_compute, self.t_memory, self.t_collective)
        t_useful_c = (self.model_flops_global / self.chips
                      / H100.peak_flops(self.dtype))
        t_useful_m = self.model_bytes_global / self.chips / H100.hbm_bytes_per_s
        return max(t_useful_c, t_useful_m) / max(bound, 1e-12)

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "dtype": self.dtype,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops_global,
            "model_bytes": self.model_bytes_global,
            "flops_per_dev": self.flops_per_device,
            "bytes_per_dev": self.bytes_per_device,
            "useful_flops_ratio": self.useful_flops_ratio,
            "useful_bytes_ratio": self.useful_bytes_ratio,
            "roofline_frac": self.roofline_frac,
            "hbm_args_gb": self.arg_bytes / 2**30,
            "hbm_temp_gb": self.temp_bytes / 2**30,
            "collectives": self.coll_counts,
            "kernels": self.kernels,
        }
