"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source in ``csrc/`` becomes one shared library with a plain C
interface (one or more entry points), compiled for Hopper (``sm_90a``) into
``build/repro_torch/`` at the repository root. A library's file name
carries a hash of its sources and flags, so an edited source is rebuilt
and an unchanged one is reused. All missing libraries are compiled in
parallel, one ``nvcc`` each.

Building happens at the first launch (or through :func:`build_all`), never at
import: the CPU tests import every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
HEADERS = ("gmm_common.cuh", "gmm_fp32.cuh", "gmm_fp32_narrow.cuh",
           "gmm_fp32_small.cuh", "gmm_tc.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# The tensor-core GEMMs encode their TMA tensor maps with the driver API's
# cuTensorMapEncodeTiled: every library links the toolkit's stub libcuda
# (see _link_dirs), after its source; at run time the driver's own
# libcuda.so.1 is loaded.
LIBS = ("-lcuda",)

_P = ctypes.c_void_p
_I = ctypes.c_int

# Kernel name → (source file, C entry point, its argtypes). Every entry point
# takes its tensors' pointers, then its ints, then the dtype code and the
# stream, and returns a cudaError_t.
KERNELS = {
    # (x, w, y, E, C, K, N, a_layout, b_layout, body, dtype, stream)
    "gmm": ("gmm.cu", "gmm_launch",
            (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P)),
    # (x, w_in, y, E, C, K, F, dtype, stream)
    "gmm_swiglu": ("gmm_swiglu.cu", "gmm_swiglu_launch",
                   (_P, _P, _P, _I, _I, _I, _I, _I, _P)),
    # (x, w_in, dout, dx, dw, dgu, E, C, K, F, tensor_cores, out_dtype,
    #  dtype, stream)
    "gmm_swiglu_bwd": ("gmm_swiglu_bwd.cu", "gmm_swiglu_bwd_launch",
                       (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _P)),
    # The three passes of swiglu_add.cu, one library. (h, g, M, F, dtype,
    # stream); (g, y, out, M, F, dtype, stream); (h, y, out, M, F, ...).
    "swiglu": ("swiglu_add.cu", "swiglu_launch", (_P, _P, _I, _I, _I, _P)),
    "add": ("swiglu_add.cu", "add_launch", (_P, _P, _P, _I, _I, _I, _P)),
    "swiglu_add": ("swiglu_add.cu", "swiglu_add_launch",
                   (_P, _P, _P, _I, _I, _I, _P)),
}
DTYPE_CODES = {"float32": 0, "bfloat16": 1}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine that has the card")


def _link_dirs(nvcc: str) -> list[str]:
    """``-L`` flags for the toolkit's stub ``libcuda.so`` beside ``nvcc``."""
    root = Path(nvcc).resolve().parents[1]
    return [f"-L{d}" for d in (root / "lib64" / "stubs",
                               *sorted(root.glob("targets/*/lib/stubs")))
            if (d / "libcuda.so").exists()]


def lib_path(src: str) -> Path:
    """Where source ``src``'s library lives for the current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LIBS).encode())
    for f in (src, *HEADERS):
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{Path(src).stem}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, Path]:
    """Compile every library of the named kernels (all by default) that is
    missing, in parallel, one per source.

    Returns ``{source: library path}``; raises with the compiler's output if
    a build fails. The compiler's report (registers, spills) is kept beside
    each library as ``<library>.log``.
    """
    srcs = list(dict.fromkeys(
        KERNELS[n][0] for n in (KERNELS if names is None else names)))
    paths = {s: lib_path(s) for s in srcs}
    todo = [s for s in srcs if not paths[s].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for src in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / src),
               *_link_dirs(nvcc), *LIBS]
        procs[src] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    failed = []
    for src, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        paths[src].with_name(paths[src].name + ".log").write_text(out)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{src}: nvcc exited {proc.returncode}\n{out}")
        else:
            os.replace(tmp, paths[src])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str):
    """The C entry point of kernel ``name``, building its library if needed."""
    src, entry, argtypes = KERNELS[name]
    if src not in _loaded:
        _loaded[src] = ctypes.CDLL(str(build_all([name])[src]))
    fn = getattr(_loaded[src], entry)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def dtype_code(dtype) -> int:
    """The C entry points' code of a torch dtype (``DTYPE_CODES``)."""
    return DTYPE_CODES[str(dtype).removeprefix("torch.")]


def c_args(name: str, args, dtype) -> list:
    """The C arguments of kernel ``name`` but the stream: each tensor's
    pointer, each int, then the dtype code. Raises if they do not fit the
    entry point's argtypes."""
    import torch
    argtypes = KERNELS[name][2]
    out = [a.data_ptr() if isinstance(a, torch.Tensor) else int(a)
           for a in args]
    out.append(dtype_code(dtype))
    if len(out) + 1 != len(argtypes) or any(
            isinstance(a, torch.Tensor) != (t is _P)
            for a, t in zip(args, argtypes)):
        raise TypeError(f"{name} takes {len(argtypes)} C arguments "
                        f"{argtypes}; got {len(out) + 1}")
    return out


def launch(name: str, *args, dtype) -> None:
    """Launch kernel ``name`` on the current stream of its first tensor's
    device; raise on an error.

    ``args`` are the entry point's arguments before the dtype code: CUDA
    tensors in the layouts the entry point takes (checked by the caller),
    then ints.
    """
    import torch
    dev = args[0].device
    cargs = c_args(name, args, dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = load(name)(*cargs, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
