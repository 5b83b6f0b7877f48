"""The port's Mamba2 SSD (``repro_torch.models.ssm``) and RG-LRU
(``repro_torch.models.rglru``) against the JAX package's, on the same numpy
inputs on the CPU, and against the plain one-step-a-token oracles of both;
then the ssm and hybrid families (mamba2-1_3b, recurrentgemma-2b) whole, at
their smoke configs, through ``tests/_torch_families.py``'s checks.

Tolerance: fp32, 1e-5 of the reference's largest value where both sides
compute in the same order (the conv, a decode step), 1e-4 for the chunked
SSD and the log-depth scan, whose sums run in another order than the
reference's; bf16 held to the port's own fp32 run, as
``tests/_torch_families.py`` states.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_families as F  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.configs import get_smoke_config as tget_smoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import rglru as TR  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

EXACT, SCAN = 1e-5, 1e-4

# The reference's functions, jitted (eager dispatch of their scans is slow).
j_ssd = jax.jit(JS._ssd_chunked, static_argnums=6)
j_ssd_ref = jax.jit(JS.ssd_reference)
j_ssm = jax.jit(JS.ssm_forward, static_argnums=2)
j_core = jax.jit(JR._rglru_core)
j_rglru_ref = jax.jit(JR.rglru_reference)
j_block = jax.jit(JR.rglru_block)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            .astype(np.float32) * np.float32(scale))


def _near(got, want, tol):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * float(np.max(np.abs(want))), (err, tol)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    x, w, b = _rand((2, 7, 12), 0), _rand((4, 12), 1), _rand((12,), 2)
    st = _rand((2, 3, 12), 3) if with_state else None
    jy, jt = JS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             None if st is None else jnp.asarray(st))
    ty, tt = TS._causal_conv(_t(x), _t(w), _t(b),
                             None if st is None else _t(st))
    _near(ty, jy, EXACT)
    _near(tt, jt, EXACT)


def _ssd_inputs(L, seed=4):
    b, H, P, N = 2, 3, 4, 5
    x = _rand((b, L, H, P), seed)
    dt = np.log1p(np.exp(_rand((b, L, H), seed + 1)))      # softplus > 0
    A = -np.exp(_rand((H,), seed + 2, 0.5))
    B, C = _rand((b, L, N), seed + 3), _rand((b, L, N), seed + 4)
    D = _rand((H,), seed + 5)
    return x, dt.astype(np.float32), A.astype(np.float32), B, C, D


@pytest.mark.parametrize("L, chunk", [(16, 4), (12, 12), (24, 8)])
def test_ssd_chunked_matches_jax_and_the_recurrence(L, chunk):
    args = _ssd_inputs(L)
    jy, jS = j_ssd(*map(jnp.asarray, args), chunk)
    ty, tS = TS._ssd_chunked(*map(_t, args), chunk)
    _near(ty, jy, SCAN)
    _near(tS, jS, SCAN)
    _near(ty, j_ssd_ref(*map(jnp.asarray, args)), SCAN)
    _near(TS.ssd_reference(*map(_t, args)),
          j_ssd_ref(*map(jnp.asarray, args)), EXACT)


def test_ssd_length_not_a_multiple_of_the_chunk_raises():
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        TS._ssd_chunked(*map(_t, _ssd_inputs(10)), 4)


def _ssm_params(d, sc, seed):
    """JAX's init (fp32) with the zero leaves redrawn, as numpy."""
    p = {k: np.asarray(v) for k, v in
         JS.init_ssm(jax.random.PRNGKey(seed), d, sc).items()}
    p["conv_b"] = _rand(p["conv_b"].shape, seed + 1, 0.1)
    p["dt_bias"] = _rand(p["dt_bias"].shape, seed + 2, 0.5)
    p["norm_w"] = _rand(p["norm_w"].shape, seed + 3, 0.1)
    p["D"] = _rand(p["D"].shape, seed + 4)
    return p


def test_ssm_prefill_then_decode_hands_the_state_over():
    """A 16-token prompt in two chunks of 8, then 4 one-token steps on the
    returned conv and ssm state, each against JAX's."""
    d = 32
    sc_j = JS.SSMConfig(d_state=8, head_dim=8, expand=2, chunk=8)
    sc_t = TS.SSMConfig(d_state=8, head_dim=8, expand=2, chunk=8)
    p = _ssm_params(d, sc_j, 5)
    H, d_in = sc_j.n_heads(d), 2 * d
    state0 = {"conv": np.zeros((2, 3, d_in + 16), np.float32),
              "ssm": np.zeros((2, H, 8, 8), np.float32)}
    x = _rand((2, 20, d), 6, 0.5)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    jy, js = j_ssm(jp, jnp.asarray(x[:, :16]), sc_j,
                            {k: jnp.asarray(v) for k, v in state0.items()})
    ty, ts = TS.ssm_forward(tp, _t(x[:, :16]), sc_t,
                            {k: _t(v) for k, v in state0.items()})
    _near(ty, jy, SCAN)
    for k in ("conv", "ssm"):
        _near(ts[k], js[k], SCAN)
    for t in range(16, 20):
        jy, js = j_ssm(jp, jnp.asarray(x[:, t:t + 1]), sc_j, js)
        ty, ts = TS.ssm_forward(tp, _t(x[:, t:t + 1]), sc_t, ts)
        _near(ty, jy, SCAN)
        _near(ts["ssm"], js["ssm"], SCAN)
    # Without a state: the whole sequence, no state returned.
    jy, _ = j_ssm(jp, jnp.asarray(x[:, :16]), sc_j)
    ty, none = TS.ssm_forward(tp, _t(x[:, :16]), sc_t)
    assert none is None
    _near(ty, jy, SCAN)


def _rglru_params(d, w, seed):
    p = {k: np.asarray(v) for k, v in
         JR.init_rglru(jax.random.PRNGKey(seed), d, w).items()}
    for k in ("conv_b", "gate_a_b", "gate_x_b"):
        p[k] = _rand(p[k].shape, seed + len(k), 0.3)
    return p


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("L", [1, 5, 37])
def test_rglru_core_matches_associative_scan_and_reference(with_h0, L):
    """The log-depth scan against ``jax.lax.associative_scan`` and both
    packages' sequential oracles; L = 1 with h0 is the decode update."""
    p = _rglru_params(16, 24, 7)
    x = _rand((2, L, 24), 8)
    h0 = _rand((2, 24), 9) if with_h0 else None
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    jh, jl = j_core(jnp.asarray(x), jp,
                            None if h0 is None else jnp.asarray(h0))
    th, tl = TR._rglru_core(_t(x), tp, None if h0 is None else _t(h0))
    _near(th, jh, SCAN)
    _near(tl, jl, SCAN)
    ref = j_rglru_ref(jnp.asarray(x), jp,
                             None if h0 is None else jnp.asarray(h0))
    _near(th, ref, SCAN)
    _near(TR.rglru_reference(_t(x), tp, None if h0 is None else _t(h0)),
          ref, EXACT)


def test_linear_scan_is_the_recurrence():
    a = torch.rand(3, 70, 5)
    b = torch.randn(3, 70, 5)
    _, h = TR.linear_scan(a, b)
    want, acc = [], torch.zeros(3, 5)
    for t in range(70):
        acc = a[:, t] * acc + b[:, t]
        want.append(acc)
    _near(h, torch.stack(want, 1).numpy(), SCAN)


def test_rglru_block_with_state_matches_jax():
    """A 9-token prompt from zero state, then 3 one-token steps on the
    returned conv and h state, each against JAX's."""
    d, w = 16, 24
    p = _rglru_params(d, w, 10)
    x = _rand((2, 12, d), 11, 0.5)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    js = {"conv": jnp.zeros((2, 3, w)), "h": jnp.zeros((2, w))}
    ts = {"conv": torch.zeros(2, 3, w), "h": torch.zeros(2, w)}
    jy, js = j_block(jp, jnp.asarray(x[:, :9]), js)
    ty, ts = TR.rglru_block(tp, _t(x[:, :9]), ts)
    _near(ty, jy, SCAN)
    for t in range(9, 12):
        jy, js = j_block(jp, jnp.asarray(x[:, t:t + 1]), js)
        ty, ts = TR.rglru_block(tp, _t(x[:, t:t + 1]), ts)
        _near(ty, jy, SCAN)
        _near(ts["h"], js["h"], SCAN)
        _near(ts["conv"], js["conv"], EXACT)


# ---------------------------------------------------------------------------
# The ssm and hybrid families whole
# ---------------------------------------------------------------------------

SCANNED = list(F.SCANNED)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SCANNED)
def test_forward_matches_jax(arch, dtype):
    F.check_forward(arch, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SCANNED)
def test_loss_and_every_grad_leaf_match_jax(arch, dtype):
    F.check_loss_and_grads(arch, dtype)


@pytest.mark.parametrize("arch", SCANNED)
def test_remat_gives_the_same_loss_and_grads(arch):
    F.check_remat(arch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SCANNED)
def test_prefill_and_teacher_forced_decode_match_jax(arch, dtype):
    F.check_decode(arch, dtype)


@pytest.mark.parametrize("arch", SCANNED)
def test_decode_consistency_with_own_forward(arch):
    F.check_decode_consistency(arch)


def test_hybrid_cache_has_the_jax_shape():
    tcfg = tget_smoke("recurrentgemma-2b")
    jcfg = jget_smoke("recurrentgemma-2b")
    tc = TM.init_cache(tcfg, 3, 40, per_slot_len=True, device="cpu")
    jc = JM.init_cache(jcfg, 3, 40, per_slot_len=True)
    assert len(tc["super"]) == len(jc["super"]) == 3
    assert len(tc["tail"]) == len(jc["tail"]) == 2
    for pos in range(3):
        for k, v in jc["super"][pos].items():
            assert tuple(v.shape[1:]) == tuple(tc["super"][pos][0][k].shape)
    assert tc["super"][2][0]["k"].shape[1] == 16        # the window's ring
    assert tc["tail"][0]["h"].dtype == torch.float32


def test_ssd_prompt_length_limit_raises():
    """mamba2's smoke chunk is 8: a 12-token prompt is neither below the
    chunk nor a multiple of it, which the reference asserts against."""
    _, tcfg = F.cfgs("mamba2-1_3b", "float32")
    params = params_from_numpy(F.inputs("mamba2-1_3b")[0], tcfg, "cpu")
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        TM.prefill(tcfg, params, {"tokens": torch.zeros((1, 12),
                                                        dtype=torch.long)},
                   max_len=20)
