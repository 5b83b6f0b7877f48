"""Port MoE layer vs ``repro.models.moe`` on the same numpy inputs and on
params made by the JAX ``init_moe``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_margin import decided  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

JMC = jmoe.MoEConfig(n_experts=5, top_k=2, d_expert=32, n_padding_experts=1)
TMC = tmoe.MoEConfig(n_experts=5, top_k=2, d_expert=32, n_padding_experts=1)
D = 64


def _params():
    jp = jmoe.init_moe(jax.random.PRNGKey(3), D, JMC)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jp, tp


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32)


def _decided(x, router, mc):
    """The rows whose expert choices can be compared exactly: the port's
    fp32 logits pick and order their top k by at least MARGIN of the row's
    range (``tests/_torch_margin.py``). Elsewhere only the probs, which do
    not jump at a tie, are compared."""
    return decided((x.float() @ router.float())[:, :mc.n_experts],
                   mc.top_k)


def test_config_fields_match():
    import dataclasses
    assert dataclasses.asdict(TMC) == dataclasses.asdict(JMC)
    assert TMC.e_total == JMC.e_total == 6


@pytest.mark.parametrize("tokens", [1, 2, 4, 7, 8, 27, 128, 1000])
def test_capacity_matches(tokens):
    assert tmoe.capacity(tokens, TMC) == jmoe.capacity(tokens, JMC)
    for ep in (1, 2, 4):
        assert tmoe.capacity(tokens, TMC, ep) == jmoe.capacity(tokens, JMC,
                                                                ep)


def test_router_topk_matches():
    jp, tp = _params()
    x = _x((40, D))   # random logits: a near-tie row compares probs only
    jprob, jidx = jmoe.router_topk(jp["router"], jnp.asarray(x), JMC)
    tprob, tidx = tmoe.router_topk(tp["router"], torch.from_numpy(x), TMC)
    ok = _decided(torch.from_numpy(x), tp["router"], TMC).numpy()
    assert ok.sum() >= 30, ok.sum()
    np.testing.assert_array_equal(tidx.numpy()[ok], np.asarray(jidx)[ok])
    np.testing.assert_allclose(tprob.numpy(), np.asarray(jprob),
                               rtol=1e-5, atol=1e-5)
    assert int(tidx.max()) < TMC.n_experts      # padding never chosen


def test_router_topk_bf16_router_matches_jax():
    """Training casts every float leaf to bf16, the router included; JAX's
    einsum promotes it to fp32, and so must the port."""
    jp, _ = _params()
    router = np.asarray(jnp.asarray(jp["router"], jnp.bfloat16), np.float32)
    x = _x((40, D), seed=7)
    jprob, jidx = jmoe.router_topk(jnp.asarray(router, jnp.bfloat16),
                                   jnp.asarray(x, jnp.bfloat16), JMC)
    tprob, tidx = tmoe.router_topk(torch.from_numpy(router).bfloat16(),
                                   torch.from_numpy(x).bfloat16(), TMC)
    assert tprob.dtype == torch.float32
    ok = _decided(torch.from_numpy(x).bfloat16(),
                  torch.from_numpy(router).bfloat16(), TMC).numpy()
    assert ok.sum() >= 30, ok.sum()
    np.testing.assert_array_equal(tidx.numpy()[ok], np.asarray(jidx)[ok])
    np.testing.assert_allclose(tprob.numpy(), np.asarray(jprob),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("C", [1, 3, 8, 40])
def test_make_dispatch_matches(C):
    rng = np.random.default_rng(1)
    T, k, E = 24, 2, 6
    top_i = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    top_p = rng.random((T, k), dtype=np.float32)
    jw, je, js = jmoe.make_dispatch(jnp.asarray(top_p), jnp.asarray(top_i),
                                    T, E, C)
    tw, te, ts = tmoe.make_dispatch(torch.from_numpy(top_p),
                                    torch.from_numpy(top_i), T, E, C)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    if C < T * k // E:
        assert (ts.numpy() == C).any()          # some choices dropped


def _jax_kernel_gmm_fn(disp, w_in, w_down, act):
    return jops.moe_expert_ffn(disp, w_in, w_down, act)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cap", [None, 3])
@pytest.mark.parametrize("kernel_ffn", [True, False])
def test_moe_grouped_matches_jax(kernel_ffn, cap, dtype):
    """cap=3 drops choices: the dispatch's extra row C and the zero row the
    combine reads for them must match."""
    jp, tp = _params()
    x = _x((2, 16, D), seed=2)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = jmoe.moe_grouped(jp, jx, JMC, cap=cap, gmm_fn=_jax_kernel_gmm_fn)
    got = tmoe.moe_grouped(tp, tx, TMC, cap=cap,
                           gmm_fn=ops.moe_expert_ffn if kernel_ffn else None)
    assert got.dtype == tx.dtype
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("cap", [None, 3])
def test_moe_grouped_matches_dense_refs(cap):
    jp, tp = _params()
    x = _x((2, 16, D), seed=4)
    jref = jmoe.moe_dense_ref(jp, jnp.asarray(x), JMC, cap=cap)
    tref = tmoe.moe_dense_ref(tp, torch.from_numpy(x), TMC, cap=cap)
    got = tmoe.moe_grouped(tp, torch.from_numpy(x), TMC, cap=cap,
                           gmm_fn=ops.moe_expert_ffn)
    np.testing.assert_allclose(tref.numpy(), np.asarray(jref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), tref.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_expert_ffn_matches():
    jp, tp = _params()
    x = _x((6, 5, D), seed=5)
    for act in ("swiglu", "geglu"):
        want = jmoe.expert_ffn(jp["w_in"], jp["w_down"], jnp.asarray(x), act)
        got = tmoe.expert_ffn(tp["w_in"], tp["w_down"], torch.from_numpy(x),
                              act)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_init_moe_draws_on_generator_device():
    gen = torch.Generator(device="cpu").manual_seed(0)
    p = tmoe.init_moe(gen, D, TMC, torch.bfloat16)
    assert p["router"].dtype == torch.float32
    assert p["w_in"].dtype == p["w_down"].dtype == torch.bfloat16
    assert tuple(p["w_in"].shape) == (6, D, 64)
    assert tuple(p["w_down"].shape) == (6, 32, D)
    again = tmoe.init_moe(torch.Generator().manual_seed(0), D, TMC,
                          torch.bfloat16)
    assert all(torch.equal(p[k], again[k]) for k in p)
