"""The port's GMM1 + SwiGLU backward and GMM2 gradient (plain versions on CPU
tensors) vs the JAX Pallas backward in interpret mode and vs JAX autodiff,
on the same numpy inputs."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.gmm_swiglu_bwd import gmm_swiglu_bwd as jbwd  # noqa: E402
from repro.models.moe import expert_ffn as jexpert_ffn  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import gmm as gmm_mod  # noqa: E402
from repro_torch.kernels import gmm_swiglu_bwd as bwd_mod  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# tests/test_kernels.py:92 (the JAX backward's shapes), then ragged C = 27 and
# C = 1 at granite's K = 1536 with narrow F (18, 40 are not multiples of the
# kernel's 4-wide groups or 256-wide chunks).
SHAPES = [(2, 128, 64, 128), (3, 64, 96, 64), (3, 27, 1536, 40),
          (3, 1, 1536, 18)]


def _inputs(seed, E, C, K, F):
    rng = np.random.default_rng(seed)
    scale = np.float32(0.1 if K <= 512 else K ** -0.5)
    x = rng.standard_normal((E, C, K), dtype=np.float32)
    w = rng.standard_normal((E, K, 2 * F), dtype=np.float32) * scale
    dout = rng.standard_normal((E, C, F), dtype=np.float32)
    return x, w, dout


def _t(a, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("E,C,K,F", SHAPES)
def test_gmm_swiglu_bwd_matches_jax_kernel(E, C, K, F, dtype, tol):
    """fp32 sums on both sides: 1e-4 is the JAX test's tolerance
    (test_kernels.py:107-110); bf16 inputs, 2e-2."""
    x, w, dout = _inputs(0, E, C, K, F)
    jd = getattr(jnp, dtype)
    w4 = w.reshape(E, K, 2, F)
    jdx, jdw4 = jbwd(jnp.asarray(x, jd), jnp.asarray(w4, jd),
                     jnp.asarray(dout, jd), interpret=True)
    dx, dw4 = bwd_mod.gmm_swiglu_bwd(_t(x, dtype), _t(w4, dtype),
                                     _t(dout, dtype))
    assert dx.dtype == dw4.dtype == torch.float32
    assert tuple(dw4.shape) == (E, K, 2, F)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(dw4.numpy(), np.asarray(jdw4), rtol=tol,
                               atol=tol)


def test_gmm_swiglu_trainable_bf16_vs_fp32_oracle():
    """Mirrors test_gmm_swiglu_vjp_bf16_vs_fp32_oracle: with its fp32 sums,
    the port's bf16 backward is at least as accurate as the all-bf16 JAX
    oracle path, against the fp32 oracle on the same bf16-rounded values."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 64, 32), dtype=np.float32)
    w = rng.standard_normal((2, 32, 128), dtype=np.float32) * np.float32(0.1)
    dout = rng.standard_normal((2, 64, 64), dtype=np.float32)
    xb, wb, db = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, dout))
    _, vjp32 = jax.vjp(jref.gmm_swiglu_ref, xb.astype(jnp.float32),
                       wb.astype(jnp.float32))
    dx32, dw32 = (np.asarray(a) for a in vjp32(db.astype(jnp.float32)))
    _, vjp_bf = jax.vjp(jref.gmm_swiglu_ref, xb, wb)
    dx_bf, dw_bf = (np.asarray(a, np.float32) for a in vjp_bf(db))

    tx = _t(x, "bfloat16").requires_grad_(True)
    tw = _t(w, "bfloat16").requires_grad_(True)
    y = bwd_mod.gmm_swiglu_trainable(tx, tw)
    y.backward(_t(dout, "bfloat16"))
    assert tx.grad.dtype == tw.grad.dtype == torch.bfloat16
    dx, dw = tx.grad.float().numpy(), tw.grad.float().numpy()

    def err(a, b):
        return float(np.max(np.abs(a - b)))

    assert err(dx, dx32) <= err(dx_bf, dx32) + 0.05
    assert err(dw, dw32) <= err(dw_bf, dw32) + 0.05
    np.testing.assert_allclose(dx, dx32, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("E,C,K,F", [(2, 16, 32, 24), (3, 27, 64, 40)])
def test_gmm_swiglu_trainable_grads_match_autograd(E, C, K, F):
    x, w, dout = _inputs(1, E, C, K, F)
    got = [_t(x).requires_grad_(True), _t(w).requires_grad_(True)]
    want = [_t(x).requires_grad_(True), _t(w).requires_grad_(True)]
    y = bwd_mod.gmm_swiglu_trainable(*got)
    y.backward(_t(dout))
    y_ref = ref.gmm_swiglu_ref(*want)
    y_ref.backward(_t(dout))
    assert torch.equal(y.detach(), y_ref.detach())
    for a, b in zip(got, want):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-5)


def _leaf(a, dtype, transposed):
    """A leaf with ``a``'s values: contiguous, or a transposed view of a
    contiguous copy (gmm reads both in place)."""
    if not transposed:
        return _t(a, dtype).requires_grad_(True)
    return _t(a.transpose(0, 2, 1), dtype).transpose(1, 2).requires_grad_(
        True)


@pytest.mark.parametrize("views", [(False, False), (True, False),
                                   (False, True), (True, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_trainable_grads_match_autograd(dtype, views):
    """The backward's two calls take transposed views of the saved operands;
    x and w may be views themselves."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 27, 40), dtype=np.float32)
    w = rng.standard_normal((3, 40, 24), dtype=np.float32) * np.float32(0.1)
    dy = rng.standard_normal((3, 27, 24), dtype=np.float32)
    got = [_leaf(a, dtype, v) for a, v in zip((x, w), views)]
    # fp32 autograd on the same (rounded) values
    want = [_t(a, dtype).float().requires_grad_(True) for a in (x, w)]
    gmm_mod.gmm_trainable(*got).backward(_t(dy, dtype))
    torch.bmm(*want).backward(_t(dy, dtype).float())
    tol = 1e-5 if dtype == "float32" else 2e-2
    for a, b in zip(got, want):
        assert a.grad.dtype == a.dtype
        assert tuple(a.grad.shape) == tuple(a.shape)
        torch.testing.assert_close(a.grad.float(), b.grad, rtol=tol, atol=tol)


@pytest.mark.parametrize("w_down_view", [False, True])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 5e-2)])
def test_moe_expert_ffn_trainable_matches_jax_einsum_vjp(dtype, tol,
                                                         w_down_view):
    """JAX's kernel-backed ``moe_expert_ffn(trainable=True)`` cannot be
    differentiated (its ``gmm`` has no VJP), so the reference is ``jax.vjp``
    of the einsum ``expert_ffn`` that the JAX package trains through.
    ``w_down_view``: GMM2's weight is a transposed view, so its forward and
    both backward calls read an operand in the other layout."""
    rng = np.random.default_rng(3)
    E, C, D, F = 4, 16, 64, 32
    x = rng.standard_normal((E, C, D), dtype=np.float32)
    w_in = rng.standard_normal((E, D, 2 * F), dtype=np.float32) * 0.1
    w_down = rng.standard_normal((E, F, D), dtype=np.float32) * 0.1
    dy = rng.standard_normal((E, C, D), dtype=np.float32)
    jd = getattr(jnp, dtype)
    y, vjp = jax.vjp(lambda a, b, c: jexpert_ffn(b, c, a, "swiglu"),
                     *(jnp.asarray(a, jd) for a in (x, w_in, w_down)))
    want = [np.asarray(g, np.float32) for g in vjp(jnp.asarray(dy, jd))]
    leaves = [_leaf(a, dtype, v) for a, v in
              zip((x, w_in, w_down), (False, False, w_down_view))]
    out = ops.moe_expert_ffn(*leaves, trainable=True)
    out.backward(_t(dy, dtype))
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(y, np.float32), rtol=tol, atol=tol)
    for leaf, g in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.float().numpy(), g, rtol=tol,
                                   atol=tol)


def test_cpu_backward_does_not_count_launches():
    x, w, dout = _inputs(4, 2, 3, 16, 8)
    bwd_mod.gmm_swiglu_bwd(_t(x), _t(w.reshape(2, 16, 2, 8)), _t(dout))
    leaves = [_t(x).requires_grad_(True), _t(w).requires_grad_(True)]
    ops.moe_expert_ffn(*leaves, torch.zeros(2, 8, 16),
                       trainable=True).sum().backward()
    assert bwd_mod.launches == bwd_mod.launches_tc == 0
    assert gmm_mod.launches == 0


def test_bwd_wrapper_rejects_bad_operands():
    x, w4, dout = torch.zeros(2, 3, 8), torch.zeros(2, 8, 2, 4), \
        torch.zeros(2, 3, 4)
    with pytest.raises(ValueError):
        bwd_mod.gmm_swiglu_bwd(x, torch.zeros(2, 8, 8), dout)   # not 4-d
    with pytest.raises(ValueError):
        bwd_mod.gmm_swiglu_bwd(x, torch.zeros(2, 7, 2, 4), dout)  # K
    with pytest.raises(ValueError):
        bwd_mod.gmm_swiglu_bwd(x, w4, torch.zeros(2, 3, 5))      # F
    with pytest.raises(TypeError):
        bwd_mod.gmm_swiglu_bwd(x, w4, dout.bfloat16())
    with pytest.raises(ValueError, match="cuda or cpu"):
        bwd_mod.gmm_swiglu_bwd(x.to("meta"), w4.to("meta"), dout.to("meta"))


_CTYPE = {"void*": ctypes.c_void_p, "int": ctypes.c_int}


@pytest.mark.parametrize("name", sorted(build.KERNELS))
def test_build_argtypes_match_each_c_entry_point(name):
    """Each kernel has its own C signature; the argtypes ``ctypes`` gets
    must match the ``extern "C"`` prototype in its source."""
    src, entry, argtypes = build.KERNELS[name]
    text = (Path(build.CSRC) / src).read_text()
    proto = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
    assert proto, f"no extern \"C\" {entry} in {src}"
    want = []
    for arg in proto.group(1).split(","):
        ctype = "void*" if "*" in arg else arg.split()[0]
        want.append(_CTYPE[ctype])
    assert list(argtypes) == want


def test_c_args_follow_the_kernels_own_signature():
    x, w, dout = (torch.zeros(2, 3, 8), torch.zeros(2, 8, 2, 4),
                  torch.zeros(2, 3, 4))
    dx, dw, dgu = torch.zeros(2, 3, 8), torch.zeros(2, 8, 2, 4), \
        torch.zeros(2, 3, 8)
    # The body (1 = tensor cores) and the output dtype's code come after
    # the sizes, before the operands' dtype code.
    args = build.c_args("gmm_swiglu_bwd", (x, w, dout, dx, dw, dgu,
                                           2, 3, 8, 4, 1, 0), torch.bfloat16)
    assert args[:6] == [t.data_ptr() for t in (x, w, dout, dx, dw, dgu)]
    assert args[6:] == [2, 3, 8, 4, 1, 0, 1]
    with pytest.raises(TypeError):       # without the body and out dtype
        build.c_args("gmm_swiglu_bwd", (x, w, dout, dx, dw, dgu,
                                        2, 3, 8, 4), torch.float32)
    with pytest.raises(TypeError):       # the forward kernels' 9 arguments
        build.c_args("gmm_swiglu_bwd", (x, w, dout, 2, 3, 8, 4),
                     torch.float32)
    # gmm's two layout codes and its body code come after its sizes,
    # before the dtype code.
    assert build.c_args("gmm", (x, w, dx, 2, 3, 8, 4, 0, 1, 0),
                        torch.float32)[-3:] == [1, 0, 0]
    with pytest.raises(TypeError):       # without the layout codes
        build.c_args("gmm", (x, w, dx, 2, 3, 8, 4), torch.float32)


@pytest.mark.parametrize("E,C,K,F", SHAPES)
def test_bf16_outputs_are_the_fp32_outputs_rounded(E, C, K, F):
    """``out_dtype=torch.bfloat16`` rounds the same fp32 sums once."""
    x, w, dout = (_t(a, "bfloat16") for a in _inputs(5, E, C, K, F))
    w4 = w.reshape(E, K, 2, F)
    dx, dw4 = bwd_mod.gmm_swiglu_bwd(x, w4, dout)
    dx_b, dw4_b = bwd_mod.gmm_swiglu_bwd(x, w4, dout,
                                         out_dtype=torch.bfloat16)
    assert dx_b.dtype == dw4_b.dtype == torch.bfloat16
    assert torch.equal(dx_b, dx.to(torch.bfloat16))
    assert torch.equal(dw4_b, dw4.to(torch.bfloat16))
    with pytest.raises(TypeError, match="out_dtype"):
        bwd_mod.gmm_swiglu_bwd(x, w4, dout, out_dtype=torch.float16)


def test_tensor_core_body_takes_what_tensor_maps_describe():
    """bf16 with K and F multiples of 8 on 16-byte aligned bases; fp32,
    a ragged F and a base 2 bytes off run the FMA body."""
    def args(dtype, C=27, K=1536, F=512, off=0):
        flat = torch.zeros(3 * C * K + off, dtype=dtype)
        return (flat[off:].view(3, C, K), torch.zeros(3, K, 2, F, dtype=dtype),
                torch.zeros(3, C, F, dtype=dtype))
    assert bwd_mod.tensor_core_body(*args(torch.bfloat16))
    assert bwd_mod.tensor_core_body(*args(torch.bfloat16, F=40))
    assert not bwd_mod.tensor_core_body(*args(torch.float32))
    assert not bwd_mod.tensor_core_body(*args(torch.bfloat16, F=18))
    assert not bwd_mod.tensor_core_body(*args(torch.bfloat16, K=36))
    assert not bwd_mod.tensor_core_body(*args(torch.bfloat16, off=1))


def _beyond(got, want, tol=2e-2):
    """Entries beyond ``chip_smoke.bwd_case``'s limit tol + tol·|want|."""
    return int(((got - want).abs() > tol + tol * want.abs()).sum())


def test_split_bf16_dgu_keeps_dw_within_the_card_check():
    """Why the tensor-core body feeds dW a hi + lo pair of bf16 dgu, and dx
    hi alone, emulated in float64 at the training C = 854: dW sums 854
    terms that cancel, so one bf16 rounding of dg, du moves near-zero sums
    past ``bwd_case``'s 2e-2 + 2e-2·|p| (the control), while hi + lo, with
    lo = bf16(v - hi), stays inside it; dx passes with hi alone."""
    E, C, K, F = 2, 854, 64, 32
    rng = np.random.default_rng(7)
    x, w4, dout = (torch.from_numpy(a).to(torch.bfloat16) for a in (
        rng.standard_normal((E, C, K), dtype=np.float32),
        rng.standard_normal((E, K, 2, F), dtype=np.float32)
        * np.float32(K ** -0.5),
        rng.standard_normal((E, C, F), dtype=np.float32)))
    dx_p, dw4_p = ref.gmm_swiglu_bwd_ref(x, w4, dout)
    # dg ‖ du in fp32, as the kernel's epilogue forms them from fp32 sums.
    xf, wf = x.float(), w4.float()
    g, u = torch.bmm(xf, wf[:, :, 0]), torch.bmm(xf, wf[:, :, 1])
    sig = torch.sigmoid(g)
    v = torch.cat([dout.float() * u * (sig * (1.0 + g * (1.0 - sig))),
                   dout.float() * (g * sig)], dim=-1)
    hi = v.to(torch.bfloat16)
    lo = (v - hi.float()).to(torch.bfloat16)
    x64, w64 = x.double(), w4.double().reshape(E, K, 2 * F)

    def dw(dgu):
        return torch.bmm(x64.transpose(1, 2), dgu.double()).reshape(
            E, K, 2, F)

    want = dw4_p.double()
    assert _beyond(dw(hi), want) > 0                   # the control
    assert _beyond(dw(hi.double() + lo.double()), want) == 0
    dx_hi = torch.bmm(hi.double(), w64.transpose(1, 2))
    assert _beyond(dx_hi, dx_p.double()) == 0
