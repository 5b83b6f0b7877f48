"""Device meshes — counterpart of ``repro.launch.mesh``.

A :class:`Mesh` names its axes (``("data", "model")`` or ``("pod", "data",
"model")``) with their sizes, and holds the comm of its ``model`` axis
(``parallel.comm``). Two kinds:

* ``make_mesh``: the ranks are virtual
  (:class:`~repro_torch.parallel.comm.VirtualComm`), all in this process,
  and each data group's program runs on that group's rows of the batch in
  turn;
* ``dist_mesh(dims)``: D x M (or P x D x M) ``torch.distributed``
  processes, one rank each at ``coords``, holding its own block of the
  batch and of each param by the mode's rules (``parallel.sharding``). It
  has a :class:`~repro_torch.parallel.comm.DistComm` for every set of axes
  (``axes_comm``): the model row (``comm``), the data column, the world.
  One model group of M processes is ``dist_mesh((1, M))``;
* ``counting_mesh(dims, rank)``: the process mesh of one rank, ``rank``,
  without processes: a :class:`~repro_torch.parallel.comm.CountingComm`
  for every set of axes, whose transfers move nothing and count
  themselves. The dry run runs that rank's program of a step on it, on the
  meta device (``launch/dryrun.py``). ``make_production_mesh`` is the
  reference's 16 x 16 (256 chips) or 2 x 16 x 16 (512 chips) as such a
  mesh.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional

from ..parallel.comm import (CommStats, CountingComm, DistComm,
                              VirtualComm)
from ..parallel.sharding import dp_axes, rank_coords


@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: dict          # axis name -> size, outermost first
    comm: object         # the comm of the "model" axis
    # A process mesh (``dist_mesh``): this process's place, and a DistComm
    # over the ranks that differ from it only in each set of axes.
    coords: Optional[dict] = None
    comms: Optional[dict] = None   # frozenset of axis names -> DistComm

    @property
    def local_rows(self) -> bool:
        """Whether this process holds its own rows (a process mesh)."""
        return self.coords is not None

    def axes_comm(self, axes):
        """The comm over ``axes`` of a process mesh."""
        return self.comms[frozenset(axes)]

    @property
    def world(self):
        return self.axes_comm(self.axis_names)

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def dp_size(self) -> int:
        """Data groups, each running its own program over the model axis."""
        return math.prod(self.shape[a] for a in dp_axes(self))


def _checked(dims, spec) -> tuple:
    if len(dims) not in (2, 3) or min(dims) < 1:
        raise ValueError(f"a mesh is DxM or PxDxM, not {spec!r}")
    return dims


def mesh_dims(spec: str) -> tuple:
    """``"DxM"`` or ``"PxDxM"``, as the launchers' ``--mesh`` takes it."""
    try:
        dims = tuple(int(n) for n in spec.lower().split("x"))
    except ValueError:
        dims = ()
    return _checked(dims, spec)


def make_mesh(dims, device="cuda") -> Mesh:
    """``(data, model)`` or ``(pod, data, model)`` virtual ranks on
    ``device``."""
    dims = _checked(tuple(int(n) for n in dims), dims)
    names = ("pod", "data", "model") if len(dims) == 3 else ("data", "model")
    return Mesh(dict(zip(names, dims)), VirtualComm(dims[-1], device))


def make_test_mesh(data: int = 2, model: int = 4, *, device="cuda") -> Mesh:
    """Small mesh of virtual ranks (the reference's forced host devices)."""
    return make_mesh((data, model), device)


def dist_mesh(dims) -> Mesh:
    """The world of ``torch.distributed`` processes as a process mesh of
    ``dims`` (``(D, M)`` or ``(P, D, M)``, their product the world size):
    global rank r at ``rank_coords(shape, r)`` (model fastest, as the
    reference numbers its devices), holding its own rows. Every process
    must call it, in the same order: it makes a group for each set of
    axes."""
    import torch.distributed as dist
    dims = _checked(tuple(int(n) for n in dims), dims)
    names = ("pod", "data", "model") if len(dims) == 3 else ("data", "model")
    shape = dict(zip(names, dims))
    world = dist.get_world_size()
    if math.prod(dims) != world:
        raise ValueError(f"mesh {'x'.join(map(str, dims))} needs "
                         f"{math.prod(dims)} processes, the world has "
                         f"{world}")
    rank = dist.get_rank()
    coords = rank_coords(shape, rank)
    stats = CommStats()
    everyone = [rank_coords(shape, r) for r in range(world)]
    comms = {}
    for axes in _axis_sets(names):
        # The ranks that share this process's coords off ``axes``; every
        # process makes every class's group, as new_group requires.
        classes = {}
        for r, c in enumerate(everyone):
            classes.setdefault(tuple(c[a] for a in names
                                     if a not in axes), []).append(r)
        mine = None
        for ranks in classes.values():
            g = (None if len(ranks) == world
                 else dist.new_group(ranks))
            if rank in ranks:
                mine = g
        comms[frozenset(axes)] = DistComm(mine, stats=stats)
    return Mesh(shape, comms[frozenset(("model",))], coords=coords,
                comms=comms)


def _axis_sets(names):
    """Every non-empty set of ``names``, as ``dist_mesh`` makes a comm
    for each."""
    for n in range(1, len(names) + 1):
        yield from itertools.combinations(names, n)


def counting_mesh(dims, rank: int = 0) -> Mesh:
    """The process mesh of ``dims`` as global rank ``rank`` sees it, with
    no processes: its ``coords`` as ``dist_mesh`` places it, and a
    ``CountingComm`` (one shared ``CommStats``) for every set of axes,
    whose rank is this process's place among the ranks that share its
    coords off those axes, in global rank order."""
    dims = _checked(tuple(int(n) for n in dims), dims)
    names = ("pod", "data", "model") if len(dims) == 3 else ("data", "model")
    shape = dict(zip(names, dims))
    if not 0 <= rank < math.prod(dims):
        raise ValueError(f"rank {rank} of a mesh of {math.prod(dims)}")
    coords = rank_coords(shape, rank)
    stats = CommStats()
    comms = {}
    for axes in _axis_sets(names):
        size, place = 1, 0
        for a in names:
            if a in axes:
                size, place = size * shape[a], place * shape[a] + coords[a]
        comms[frozenset(axes)] = CountingComm(size, place, stats=stats)
    return Mesh(shape, comms[frozenset(("model",))], coords=coords,
                comms=comms)


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0) -> Mesh:
    """The reference's production mesh, 16 x 16 (``data``, ``model``: 256
    chips) or with ``multi_pod`` 2 x 16 x 16 (``pod``, ``data``,
    ``model``: 512 chips), as a counting mesh of rank ``rank``."""
    return counting_mesh((2, 16, 16) if multi_pod else (16, 16), rank)


def model_axis_size(mesh) -> int:
    return mesh.shape.get("model", 1)
