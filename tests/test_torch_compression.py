"""The port's gradient compression (``parallel.compression``) and AdamW's
``grad_transform`` hook vs the JAX package, on param trees made from a
numpy seed."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel import compression as jc  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.parallel import compression as tc  # noqa: E402


def _tree(rng, scale=1.0):
    f32 = np.float32
    return {"w": (rng.standard_normal((6, 8)) * scale).astype(f32),
            "b": (rng.standard_normal((8,)) * scale * 1e-3).astype(f32),
            "blocks": [{"u": (rng.standard_normal((3, 4, 5)) * scale)
                        .astype(f32)} for _ in range(2)]}


def _leaves_close(got, want, **kw):
    g = tadamw.tree_leaves(got)
    w = jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), **kw)


def _torch(tree, dtype=torch.float32):
    return tadamw.tree_map(lambda a: torch.from_numpy(a).to(dtype), tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_compress_matches_jax(dtype):
    g = _tree(np.random.default_rng(0), 3.0)
    got = tc.bf16_compress(_torch(g, getattr(torch, dtype)))
    want = jc.bf16_compress(jax.tree.map(
        lambda a: jnp.asarray(a, getattr(jnp, dtype)), g))
    _leaves_close(got, want, rtol=0, atol=0)
    assert all(t.dtype == getattr(torch, dtype)
               for t in tadamw.tree_leaves(got))


def test_int8_error_feedback_carries_the_residual_three_steps():
    """Each step's dequantized grads and the carried error equal JAX's;
    the error stays below half a step of each tensor's scale, and over the
    three steps the dequantized sums track the true sums within it."""
    rng = np.random.default_rng(1)
    t_err = tc.int8_ef_init(_torch(_tree(rng)))
    j_err = jc.int8_ef_init(jax.tree.map(jnp.asarray, _tree(rng)))
    _leaves_close(t_err, j_err, rtol=0, atol=0)
    total_g = total_d = None
    for step in range(3):
        g = _tree(rng, 1.0 + step)
        t_deq, t_err = tc.int8_ef_compress(_torch(g), t_err)
        j_deq, j_err = jc.int8_ef_compress(jax.tree.map(jnp.asarray, g),
                                           j_err)
        _leaves_close(t_deq, j_deq, rtol=1e-6, atol=1e-7)
        _leaves_close(t_err, j_err, rtol=1e-5, atol=1e-6)
        gt = torch.cat([t.flatten() for t in tadamw.tree_leaves(_torch(g))])
        dt = torch.cat([t.flatten() for t in tadamw.tree_leaves(t_deq)])
        total_g = gt if total_g is None else total_g + gt
        total_d = dt if total_d is None else total_d + dt
    err = torch.cat([t.flatten() for t in tadamw.tree_leaves(t_err)])
    torch.testing.assert_close(total_g - total_d, err, rtol=1e-5,
                               atol=1e-5)


def test_apply_updates_runs_the_grad_transform_like_jax():
    """Three AdamW steps with ``grad_transform=bf16_compress``: params,
    moments and the grad norm (taken after the transform) equal JAX's
    within 1e-6; a transform that zeroes the grads leaves the moments
    zero."""
    rng = np.random.default_rng(2)
    p0 = _tree(rng)
    oc = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = _torch(p0)
    js, ts = jadamw.init_opt_state(jp), tadamw.init_opt_state(tp)
    for _ in range(3):
        g = _tree(rng, 3.0)
        jp, js, jm = jadamw.apply_updates(
            jp, jax.tree.map(jnp.asarray, g), js, jadamw.OptConfig(**oc),
            grad_transform=jc.bf16_compress)
        tp, ts, tm = tadamw.apply_updates(
            tp, _torch(g), ts, tadamw.OptConfig(**oc),
            grad_transform=tc.bf16_compress)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
    _leaves_close(tp, jp, rtol=1e-6, atol=1e-6)
    _leaves_close(ts["m"], js["m"], rtol=1e-6, atol=1e-7)
    zp = _torch(p0)
    zs = tadamw.init_opt_state(zp)
    tadamw.apply_updates(zp, _torch(_tree(rng)), zs, tadamw.OptConfig(**oc),
                         grad_transform=lambda gr: tadamw.tree_map(
                             torch.zeros_like, gr))
    assert all(float(m.abs().max()) == 0
               for m in tadamw.tree_leaves(zs["m"]))
