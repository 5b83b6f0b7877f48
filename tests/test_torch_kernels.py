"""Port kernels (plain versions on CPU tensors) vs the JAX Pallas kernels in
interpret mode, on the same numpy inputs."""

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
from repro_torch.kernels import ops, ref  # noqa: E402

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
    # Neither CPU nor CUDA: no plain-version fallback, the call raises.
    with pytest.raises(ValueError, match="cuda or cpu"):
        fn(x.to("meta"), torch.zeros(2, 8, 4, device="meta"))
