"""Device meshes — counterpart of ``repro.launch.mesh``.

A :class:`Mesh` names its axes (``("data", "model")`` or ``("pod", "data",
"model")``) with their sizes, and holds the comm of its ``model`` axis
(``parallel.comm``). On one card the ranks of the model axis are virtual
(:class:`~repro_torch.parallel.comm.VirtualComm`), and each data group's
program runs on that group's rows of the batch in turn. A
:class:`~repro_torch.parallel.comm.DistComm` mesh is one model group of
processes (its data axes are 1): each process holds its group's rows.

The reference's ``make_production_mesh`` (16 x 16 or 2 x 16 x 16 chips)
needs a cluster and is not ported.
"""

from __future__ import annotations

import dataclasses
import math

from ..parallel.comm import DistComm, VirtualComm


@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: dict          # axis name -> size, outermost first
    comm: object         # the comm of the "model" axis

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


def dist_mesh(group=None) -> Mesh:
    """This process's model group of ``torch.distributed`` ranks."""
    comm = DistComm(group)
    return Mesh({"data": 1, "model": comm.ep}, comm)


def dp_axes(mesh) -> tuple[str, ...]:
    """The pure data-parallel axes of a mesh (pod is outer DP)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axis_size(mesh) -> int:
    return mesh.shape.get("model", 1)
