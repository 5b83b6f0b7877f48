"""Port kernels (plain versions on CPU tensors) vs the JAX Pallas kernels in
interpret mode, on the same numpy inputs."""

import re
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.gmm import gmm as jgmm  # noqa: E402
from repro.kernels.gmm_swiglu import gmm_swiglu as jgmm_swiglu  # noqa: E402
from repro_torch.kernels import gmm as gmm_mod  # noqa: E402
from repro_torch.kernels import gmm_swiglu as swiglu_mod  # noqa: E402
from repro_torch.kernels import gmm_swiglu_bwd as bwd_mod  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.launch import bench_gmm_fma, profile_train  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# tests/test_kernels.py:14-19 and :41-42, then granite's K = 1536 at the
# serving path's ragged capacities C ∈ {1, 2, 27} with narrow N (18 is not a
# multiple of the kernels' 4-wide vectors, 40 and 160 not of their 64-wide
# tiles).
SHAPES_GMM = [
    (1, 128, 64, 128),
    (4, 256, 192, 256),
    (3, 64, 96, 160),
    (8, 512, 128, 64),
    (3, 1, 1536, 18),
    (3, 2, 1536, 40),
    (3, 27, 1536, 160),
]
SHAPES_SWIGLU = [
    (2, 128, 64, 128),
    (4, 192, 96, 64),
    (1, 256, 128, 384),
    (3, 1, 1536, 18),
    (3, 2, 1536, 40),
    (3, 27, 1536, 40),
]
DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=1e-5, atol=1e-5)


def _pair(a, dtype):
    """The same values as a JAX array and a torch CPU tensor of ``dtype``."""
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _inputs(seed, x_shape, w_shape):
    rng = np.random.default_rng(seed)
    K = x_shape[-1]
    # The JAX tests scale w by 0.1; at K = 1536 by K**-0.5, as granite's init.
    scale = 0.1 if K <= 512 else K ** -0.5
    x = rng.standard_normal(x_shape, dtype=np.float32)
    w = (rng.standard_normal(w_shape, dtype=np.float32)
         * np.float32(scale))
    return x, w


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("E,C,K,N", SHAPES_GMM)
def test_gmm_matches_jax_kernel(E, C, K, N, dtype):
    x, w = _inputs(0, (E, C, K), (E, K, N))
    (jx, tx), (jw, tw) = _pair(x, dtype), _pair(w, dtype)
    got = gmm_mod.gmm(tx, tw)
    assert got.dtype == tx.dtype and tuple(got.shape) == (E, C, N)
    _close(got, jgmm(jx, jw, interpret=True), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("E,C,K,F", SHAPES_SWIGLU)
def test_gmm_swiglu_matches_jax_kernel(E, C, K, F, dtype):
    x, w = _inputs(1, (E, C, K), (E, K, 2 * F))
    (jx, tx), (jw, tw) = _pair(x, dtype), _pair(w, dtype)
    got = swiglu_mod.gmm_swiglu(tx, tw)
    assert got.dtype == tx.dtype and tuple(got.shape) == (E, C, F)
    _close(got, jgmm_swiglu(jx, jw, interpret=True), dtype)


def test_gmm_swiglu_ref_rounds_once_in_bf16():
    """The plain version follows the kernel: SwiGLU on fp32 sums, one cast.
    (The JAX einsum oracle rounds h to bf16 first; it is not the target.)"""
    x, w = _inputs(2, (2, 8, 64), (2, 64, 32))
    tx = torch.from_numpy(x).bfloat16()
    tw = torch.from_numpy(w).bfloat16()
    xf, wf = tx.float(), tw.float()
    g, u = torch.bmm(xf, wf[..., :16]), torch.bmm(xf, wf[..., 16:])
    want = (g * torch.sigmoid(g) * u).bfloat16()
    assert torch.equal(ref.gmm_swiglu_ref(tx, tw), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_moe_expert_ffn_matches_jax(act, dtype):
    rng = np.random.default_rng(3)
    E, C, D, F = 4, 16, 64, 32
    x = rng.standard_normal((E, C, D), dtype=np.float32)
    w_in = rng.standard_normal((E, D, 2 * F), dtype=np.float32) * 0.1
    w_down = rng.standard_normal((E, F, D), dtype=np.float32) * 0.1
    jx, tx = _pair(x, dtype)
    # Weights stay fp32 (the JAX masters); both sides cast them to x's dtype.
    want = jops.moe_expert_ffn(jx, jnp.asarray(w_in), jnp.asarray(w_down),
                               act)
    got = ops.moe_expert_ffn(tx, torch.from_numpy(w_in),
                             torch.from_numpy(w_down), act)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_expert_ffn_trainable_gives_the_forward_and_grads(dtype):
    """trainable=True is the same forward, and it is differentiable."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, 16, 64), dtype=np.float32))
    w_in = torch.from_numpy(rng.standard_normal((4, 64, 64),
                                                dtype=np.float32) * 0.1)
    w_down = torch.from_numpy(rng.standard_normal((4, 32, 64),
                                                  dtype=np.float32) * 0.1)
    x = x.to(getattr(torch, dtype)).requires_grad_(True)
    w_in.requires_grad_(True)
    w_down.requires_grad_(True)
    out = ops.moe_expert_ffn(x, w_in, w_down, trainable=True)
    assert torch.equal(out, ops.moe_expert_ffn(x, w_in, w_down))
    out.float().square().sum().backward()
    for t in (x, w_in, w_down):
        assert t.grad is not None and t.grad.dtype == t.dtype
        assert bool(torch.isfinite(t.grad).all()) and t.grad.abs().sum() > 0


def test_cpu_calls_do_not_count_launches():
    before = (gmm_mod.launches, swiglu_mod.launches, bwd_mod.launches)
    x, w = _inputs(4, (2, 3, 16), (2, 16, 8))
    ops.moe_expert_ffn(torch.from_numpy(x), torch.from_numpy(w),
                       torch.zeros(2, 4, 16))
    ops.grouped_gemm(torch.from_numpy(x), torch.from_numpy(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    ops.moe_expert_ffn(tx, torch.from_numpy(w), torch.zeros(2, 4, 16),
                       trainable=True).sum().backward()
    assert tx.grad is not None
    assert (gmm_mod.launches, swiglu_mod.launches,
            bwd_mod.launches) == before == (0, 0, 0)


@pytest.mark.parametrize("fn", [gmm_mod.gmm, swiglu_mod.gmm_swiglu])
def test_wrappers_reject_bad_operands(fn):
    x = torch.zeros(2, 3, 8)
    with pytest.raises(ValueError):
        fn(x, torch.zeros(3, 8, 4))                       # E mismatch
    with pytest.raises(ValueError):
        fn(x, torch.zeros(2, 7, 4))                       # K mismatch
    with pytest.raises(TypeError):
        fn(x, torch.zeros(2, 8, 4, dtype=torch.bfloat16))  # mixed dtypes
    with pytest.raises(TypeError):
        fn(x.half(), torch.zeros(2, 8, 4, dtype=torch.half))
    # Meta: no plain-version fallback; nothing runs, and the output has
    # the kernel's shape and dtype (the dry run counts the kernel's work).
    out = fn(x.to("meta"), torch.zeros(2, 8, 4, device="meta"))
    n = 2 if fn is swiglu_mod.gmm_swiglu else 4
    assert out.is_meta and tuple(out.shape) == (2, 3, n)
    assert out.dtype == x.dtype


# gmm's layouts: x as a view of [E, K, C], w as a view of [E, N, K] where 1.
VIEW_LAYOUTS = [(1, 0), (0, 1), (1, 1)]


def _view(a, transposed, dtype):
    """``a`` [E, R, S] as a torch tensor of ``dtype``: contiguous, or the
    transposed view of a contiguous [E, S, R] copy."""
    if not transposed:
        return torch.from_numpy(a).to(getattr(torch, dtype))
    t = torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1)))
    return t.to(getattr(torch, dtype)).transpose(1, 2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layouts", VIEW_LAYOUTS)
@pytest.mark.parametrize("E,C,K,N", [(3, 27, 40, 24), (2, 64, 96, 128),
                                     (1, 65, 48, 40)])
def test_gmm_on_views_matches_jax_kernel(E, C, K, N, layouts, dtype):
    """The layouts gmm_trainable's backward and the dropless tiles (E = 1)
    pass (transposed views, read in place by the kernel) give the JAX
    kernel's result on the same values."""
    x, w = _inputs(6, (E, C, K), (E, K, N))
    tx, tw = _view(x, layouts[0], dtype), _view(w, layouts[1], dtype)
    assert gmm_mod.operand_layout(tx, "x") == layouts[0]
    assert gmm_mod.operand_layout(tw, "w") == layouts[1]
    got = gmm_mod.gmm(tx, tw)
    assert got.is_contiguous() and tuple(got.shape) == (E, C, N)
    jx, jw = (jnp.asarray(a, getattr(jnp, dtype)) for a in (x, w))
    _close(got, jgmm(jx, jw, interpret=True), dtype)


@pytest.mark.parametrize("bad", ["strided_rows", "permuted", "broadcast_w"])
def test_gmm_raises_on_a_layout_it_does_not_take(bad):
    """The kernel reads a contiguous operand or the transpose of one; any
    other strides raise, on the CPU as on the card."""
    x, w = torch.zeros(2, 6, 8), torch.zeros(2, 8, 4)
    if bad == "strided_rows":
        x = torch.zeros(2, 12, 8)[:, ::2]                  # every other row
    elif bad == "permuted":
        x = torch.zeros(6, 2, 8).transpose(0, 1)           # E not outermost
    else:
        w = torch.zeros(1, 8, 4).expand(2, 8, 4)           # stride 0 over E
    with pytest.raises(ValueError, match="strides"):
        gmm_mod.gmm(x, w)


def test_operand_layout_of_degenerate_dims():
    """With one row or one column both addressings coincide: code 0."""
    assert gmm_mod.operand_layout(torch.zeros(3, 1, 8), "x") == 0
    assert gmm_mod.operand_layout(torch.zeros(3, 8, 1).transpose(1, 2),
                                  "x") == 0
    assert gmm_mod.operand_layout(torch.zeros(3, 8, 5).transpose(1, 2),
                                  "x") == 1


def _csrc_files():
    return sorted(p for p in build.CSRC.iterdir()
                  if p.suffix in (".cu", ".cuh"))


def test_every_csrc_include_is_a_build_header():
    """A header a source includes must be hashed into the library names, or
    an edited header would leave a stale library in place."""
    included = {m for p in _csrc_files()
                for m in re.findall(r'#include "([^"]+)"', p.read_text())}
    assert included and included <= set(build.HEADERS)
    assert all((build.CSRC / h).exists() for h in build.HEADERS)


@pytest.mark.parametrize("header", build.HEADERS)
def test_editing_a_header_changes_every_library_name(header, tmp_path,
                                                     monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    srcs = sorted({src for src, _, _ in build.KERNELS.values()})
    before = {s: build.lib_path(s) for s in srcs}
    with open(csrc / header, "a") as f:
        f.write("// edited\n")
    after = {s: build.lib_path(s) for s in srcs}
    assert all(before[s] != after[s] for s in srcs)


def test_every_kernel_namespace_has_a_profile_bucket():
    """profile_train sorts device time by the C++ namespaces of the port's
    kernels; a namespace without a bucket would land among other kernels."""
    spaces = {m for p in _csrc_files() for m in
              re.findall(r"^namespace (\w+) \{", p.read_text(), re.M)}
    buckets = {part.removesuffix("::")
               for part in profile_train.OWN.values()}
    assert spaces and spaces <= buckets
    # No bucket's prefix is part of another's name, so none counts twice.
    assert not any(a != b and (a + "::") in (b + "::")
                   for a in buckets for b in buckets)


def test_fma_bench_checks_every_call_on_the_cpu():
    """bench_gmm_fma holds each FMA-body call against its plain version; on
    the CPU it checks without times, and it refuses a missing card."""
    out = bench_gmm_fma.main(["--device", "cpu", "--smoke", "--rows", "3,17"])
    calls = [r["call"] for r in out["rows"]]
    assert calls.count("dropless_gmm1") == calls.count("dropless_gmm2") == 2
    assert {"dropless_gmm1_wgrad", "dropless_gmm2_act_grad", "fixed_gmm",
            "fixed_gmm_swiglu"} <= set(calls)
    assert all(r["ok"] and r["bound_ms"] > 0 and "ms" not in r
               for r in out["rows"])
    # Each row names the fp32 body the card would run it on.
    assert all(r["body"] in ("tiled", "narrow", "small", "fma")
               for r in out["rows"])
    assert all(r["body"] == "fma" for r in out["rows"]
               if r["kernel"] == "gmm_swiglu")
    # Calls too small for the tiled body: the narrow body, the small-row
    # body where x is a transposed view (the weight gradients at the smoke
    # widths).
    assert all(r["body"] == ("small" if r["x"] == "transposed view"
                             else "narrow") for r in out["rows"]
               if r["kernel"] == "gmm"
               and not gmm_mod.tiled_takes(r["E"], r["C"], r["N"]))
    assert out["fp32_bodies"] and all(
        r["fp32_bodies"] == out["fp32_bodies"] for r in out["rows"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_gmm_fma.main(["--smoke"])


@pytest.mark.parametrize("shape,layouts,dtype,want", [
    ((12, 688, 1536, 1024), (0, 0), torch.bfloat16, True),   # EP ring GMM1
    ((12, 512, 2752, 1536), (1, 0), torch.bfloat16, True),   # its dW
    ((8, 2560, 2048, 7168), (0, 1), torch.bfloat16, True),   # paper dx
    ((3, 27, 1536, 18), (0, 0), torch.bfloat16, False),      # N = 18
    ((3, 27, 40, 24), (1, 0), torch.bfloat16, False),        # lda = C = 27
    ((2, 64, 854, 16), (0, 1), torch.bfloat16, False),       # ldb = K = 854
    ((12, 688, 1536, 1024), (0, 0), torch.float32, False),   # fp32
])
def test_tensor_core_body_follows_the_c_entry_rule(shape, layouts, dtype,
                                                   want):
    """``gmm.tensor_core_body`` (the launches_tc counters of gmm and
    gmm_swiglu) mirrors ``gmmtc::usable``: bf16, 16-byte aligned bases,
    both row strides and the output width multiples of 8."""
    E, C, K, N = shape
    la, lb = layouts
    x = torch.zeros((E, K, C) if la else (E, C, K), dtype=dtype)
    w = torch.zeros((E, N, K) if lb else (E, K, N), dtype=dtype)
    x = x.transpose(1, 2) if la else x
    w = w.transpose(1, 2) if lb else w
    out = torch.zeros((E, C, N), dtype=dtype)
    assert gmm_mod.tensor_core_body(x, w, out, layouts) is want
    if want:                                  # an unaligned output base
        shifted = torch.zeros(E * C * N + 1, dtype=dtype)[1:]
        assert not gmm_mod.tensor_core_body(x, w, shifted.view(E, C, N),
                                            layouts)
