"""PyTorch/CUDA port of the ``repro`` package, for NVIDIA Hopper (H100).

The JAX package under ``src/repro`` is the reference; this package keeps its
layout and names (``configs``, ``kernels``, ``models``, ``launch``) so each
function has an obvious counterpart, and imports nothing from it. The Pallas
kernels become hand-written CUDA C++ kernels for ``sm_90a``
(``kernels/csrc``), built with ``nvcc`` at first use.

Entry points run on the card unless the caller passes ``device="cpu"``; on a
CPU tensor each kernel wrapper runs its plain PyTorch version instead.
"""

from .device import resolve_device  # noqa: F401
