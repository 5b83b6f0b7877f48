"""Port layer primitives vs ``repro.models.layers`` on the same numpy
inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape,
                                                        dtype=np.float32)
            * np.float32(scale))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def test_norms_match():
    x, w, b = _rand((2, 5, 48), 0), _rand((48,), 1, 0.1), _rand((48,), 2)
    _close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    _close(TL.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b)),
           JL.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    p_t = {"ln1": torch.from_numpy(w), "ln1_b": torch.from_numpy(b)}
    p_j = {"ln1": jnp.asarray(w), "ln1_b": jnp.asarray(b)}
    for kind in ("rmsnorm", "layernorm", "nonparam_ln"):
        _close(TL.apply_norm(kind, torch.from_numpy(x), p_t, "ln1"),
               JL.apply_norm(kind, jnp.asarray(x), p_j, "ln1"))
    # bf16 in, bf16 out, fp32 inside
    xb = torch.from_numpy(x).bfloat16()
    _close(TL.rms_norm(xb, torch.from_numpy(w)),
           JL.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w)),
           rtol=2e-2, atol=2e-2)


def test_rope_matches():
    pos = np.array([[0, 1, 2, 7], [5, 6, 7, 300]], np.int32)
    jc, js = JL.rope_tables(jnp.asarray(pos), 16, 10000.0)
    tc, ts = TL.rope_tables(torch.from_numpy(pos), 16, 10000.0)
    _close(tc, jc)
    _close(ts, js)
    x = _rand((2, 4, 3, 16), 3)
    _close(TL.apply_rope(torch.from_numpy(x), tc, ts),
           JL.apply_rope(jnp.asarray(x), jc, js))


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("Sk,block", [(20, 8), (16, 16), (9, 1024)])
def test_blockwise_attention_matches(Sk, block, window):
    B, H, K, hd = 2, 4, 2, 8
    q = _rand((B, Sk, H, hd), 4)
    k, v = _rand((B, Sk, K, hd), 5), _rand((B, Sk, K, hd), 6)
    want = JL.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, q_offset=0,
                                  sliding_window=window, block=block)
    got = TL.blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=True,
                                 q_offset=0, sliding_window=window,
                                 block=block)
    _close(got, want)


def _attn_inputs(Sk, grad=False):
    B, H, K, hd = 2, 4, 2, 8
    q, k, v = (torch.from_numpy(_rand((B, Sk, n, hd), seed))
               for n, seed in ((H, 4), (K, 5), (K, 6)))
    return [t.requires_grad_(grad) for t in (q, k, v)]


def test_blockwise_attention_backward_keeps_no_block_scores():
    """As JAX checkpoints each KV block (layers.py:150-155), the backward
    recomputes a block's fp32 scores. The memory that autograd keeps for it
    (distinct storages of the tensors saved outside the blocks' checkpoints)
    grows with the number of blocks only by the per-block carries, and is
    less than the scores of a single block."""
    Sk = 256

    def saved_bytes(block):
        storages = {}

        def pack(t):
            st = t.untyped_storage()
            storages[st.data_ptr()] = st.nbytes()
            return t

        q, k, v = _attn_inputs(Sk, grad=True)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = TL.blockwise_attention(q, k, v, causal=True, q_offset=0,
                                         block=block)
        out.sum().backward()
        return sum(storages.values()), q.shape

    whole, (B, Sq, H, hd) = saved_bytes(Sk)
    quarter, _ = saved_bytes(Sk // 4)
    carries = 4 * (2 * B * H * Sq + B * Sq * H * hd)     # m, l, o in fp32
    assert quarter <= whole + 3 * carries
    assert whole < 4 * B * H * Sq * Sk                   # one block's scores


@pytest.mark.parametrize("window", [0, 5])
def test_blockwise_attention_grads_match(window):
    """Grads through the per-block checkpoints vs jax.vjp of the reference,
    which checkpoints each block too."""
    q, k, v = _attn_inputs(20, grad=True)
    dout = _rand(tuple(q.shape), 7)
    kw = dict(causal=True, q_offset=0, sliding_window=window, block=8)
    _, vjp = jax.vjp(lambda a, b, c: JL.blockwise_attention(a, b, c, **kw),
                     *(jnp.asarray(t.detach().numpy()) for t in (q, k, v)))
    TL.blockwise_attention(q, k, v, **kw).backward(torch.from_numpy(dout))
    for t, want in zip((q, k, v), vjp(jnp.asarray(dout))):
        _close(t.grad, want)


def test_blockwise_attention_checkpoints_only_under_grad(monkeypatch):
    calls = []

    def counting(fn, *args, **kw):
        calls.append(kw)
        return checkpoint(fn, *args, **kw)

    monkeypatch.setattr(TL, "checkpoint", counting)
    q, k, v = _attn_inputs(20, grad=True)
    with torch.no_grad():
        TL.blockwise_attention(q, k, v, causal=True, q_offset=0, block=8)
    with torch.inference_mode():
        TL.blockwise_attention(q, k, v, causal=True, q_offset=0, block=8)
    assert calls == []
    TL.blockwise_attention(*_attn_inputs(20), causal=True, q_offset=0,
                           block=8)
    assert calls == []                    # nothing requires grad
    TL.blockwise_attention(q, k, v, causal=True, q_offset=0, block=8)
    assert calls == [{"use_reentrant": False}] * 3


@pytest.mark.parametrize("lens", [7, [3, 12, 1]])
def test_decode_attention_matches(lens):
    B, S, H, K, hd = 3, 12, 6, 2, 8
    q = _rand((B, 1, H, hd), 7)
    kc, vc = _rand((B, S, K, hd), 8), _rand((B, S, K, hd), 9)
    ln = np.asarray(lens, np.int32)
    want = JL.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(ln))
    got = TL.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                              torch.from_numpy(vc), torch.from_numpy(ln))
    _close(got, want)


def _attn_params(d, H, K, hd):
    jp = JL.init_attention(jax.random.PRNGKey(0), d, H, K, hd)
    return jp, {n: torch.from_numpy(np.array(a)) for n, a in jp.items()}


KW = dict(n_heads=4, n_kv_heads=2, head_dim=8, rope_theta=10000.0)


def test_attention_without_cache_matches():
    jp, tp = _attn_params(32, 4, 2, 8)
    x = _rand((2, 10, 32), 10)
    jo, jc = JL.attention(jp, jnp.asarray(x), block=4, **KW)
    to, tc = TL.attention(tp, torch.from_numpy(x), block=4, **KW)
    assert jc is None and tc is None
    _close(to, jo)


def test_attention_prefill_then_per_slot_decode_matches():
    """Prefill into an empty cache (scalar len), then one-token decodes with
    per-slot [B] lengths, one of them at the end of the cache (the write
    index is clamped, as JAX's dynamic_update_slice clamps it)."""
    jp, tp = _attn_params(32, 4, 2, 8)
    B, S, W = 3, 6, 10
    x = _rand((B, S, 32), 11)
    jcache = {"k": jnp.zeros((B, W, 2, 8)), "v": jnp.zeros((B, W, 2, 8)),
              "len": jnp.int32(0)}
    tcache = {"k": torch.zeros(B, W, 2, 8), "v": torch.zeros(B, W, 2, 8),
              "len": torch.zeros((), dtype=torch.int32)}
    jo, jc = JL.attention(jp, jnp.asarray(x), cache=jcache, block=4, **KW)
    to, tc = TL.attention(tp, torch.from_numpy(x), cache=tcache, block=4,
                          **KW)
    _close(to, jo)
    for n in ("k", "v", "len"):
        _close(tc[n], jc[n])

    lens = np.array([6, 2, W + 3], np.int32)     # slot 2 is past the end
    jc = dict(jc, len=jnp.asarray(lens))
    tc = dict(tc, len=torch.from_numpy(lens))
    for step in range(2):
        xt = _rand((B, 1, 32), 12 + step)
        jo, jc = JL.attention(jp, jnp.asarray(xt), cache=jc, **KW)
        to, tc = TL.attention(tp, torch.from_numpy(xt), cache=tc, **KW)
        _close(to, jo)
        for n in ("k", "v", "len"):
            _close(tc[n], jc[n])


def _caches(B, W, lens=0):
    lens = np.asarray(lens, np.int32)
    return ({"k": jnp.zeros((B, W, 2, 8)), "v": jnp.zeros((B, W, 2, 8)),
             "len": jnp.asarray(lens)},
            {"k": torch.zeros(B, W, 2, 8), "v": torch.zeros(B, W, 2, 8),
             "len": torch.from_numpy(lens)})


def _same_cache(tc, jc):
    for n in ("k", "v", "len"):
        _close(tc[n], jc[n])


def test_attention_rejects_window_caches():
    """Window caches, which the port once rejected, now follow JAX: a
    6-token prompt into a 4-slot ring (the last 4 keys rolled to their
    slots), then decode steps that wrap the ring, scalar length."""
    jp, tp = _attn_params(32, 4, 2, 8)
    jc, tc = _caches(1, 4)
    x = _rand((1, 6, 32), 20)
    jo, jc = JL.attention(jp, jnp.asarray(x), cache=jc, sliding_window=4,
                          block=4, **KW)
    to, tc = TL.attention(tp, torch.from_numpy(x), cache=tc,
                          sliding_window=4, block=4, **KW)
    _close(to, jo)
    _same_cache(tc, jc)
    for step in range(5):
        xt = _rand((1, 1, 32), 21 + step)
        jo, jc = JL.attention(jp, jnp.asarray(xt), cache=jc,
                              sliding_window=4, **KW)
        to, tc = TL.attention(tp, torch.from_numpy(xt), cache=tc,
                              sliding_window=4, **KW)
        _close(to, jo)
        _same_cache(tc, jc)


@pytest.mark.parametrize("S", [4, 6, 9])
def test_ring_prefill_then_decode_matches(S):
    """A W = 6 ring under window 6: prompts shorter than, equal to and
    longer than the ring, then 7 scalar-length decode steps past it."""
    jp, tp = _attn_params(32, 4, 2, 8)
    jc, tc = _caches(2, 6)
    x = _rand((2, S, 32), 30 + S)
    jo, jc = JL.attention(jp, jnp.asarray(x), cache=jc, sliding_window=6,
                          block=4, **KW)
    to, tc = TL.attention(tp, torch.from_numpy(x), cache=tc,
                          sliding_window=6, block=4, **KW)
    _close(to, jo)
    _same_cache(tc, jc)
    for step in range(7):
        xt = _rand((2, 1, 32), 40 + step)
        jo, jc = JL.attention(jp, jnp.asarray(xt), cache=jc,
                              sliding_window=6, **KW)
        to, tc = TL.attention(tp, torch.from_numpy(xt), cache=tc,
                              sliding_window=6, **KW)
        _close(to, jo)
        _same_cache(tc, jc)


def test_ring_decode_wraps_per_slot_lengths():
    """Continuous batching on a W = 6 ring: per-slot lengths 2, 6 and 11
    (the last slot has wrapped; an idle slot runs on unclamped)."""
    jp, tp = _attn_params(32, 4, 2, 8)
    rng = np.random.default_rng(50)
    jc, tc = _caches(3, 6, [2, 6, 11])
    kv = rng.standard_normal((2, 3, 6, 2, 8)).astype(np.float32)
    jc = dict(jc, k=jnp.asarray(kv[0]), v=jnp.asarray(kv[1]))
    tc = dict(tc, k=torch.from_numpy(kv[0].copy()),
              v=torch.from_numpy(kv[1].copy()))
    for step in range(8):
        xt = _rand((3, 1, 32), 51 + step)
        jo, jc = JL.attention(jp, jnp.asarray(xt), cache=jc,
                              sliding_window=6, **KW)
        to, tc = TL.attention(tp, torch.from_numpy(xt), cache=tc,
                              sliding_window=6, **KW)
        _close(to, jo)
        _same_cache(tc, jc)


def test_window_over_a_full_cache_matches():
    """A cache longer than the window (a dense layer with a window) is no
    ring: writes are clamped as before and decode masks keys older than the
    window."""
    jp, tp = _attn_params(32, 4, 2, 8)
    jc, tc = _caches(2, 12)
    x = _rand((2, 7, 32), 60)
    jo, jc = JL.attention(jp, jnp.asarray(x), cache=jc, sliding_window=3,
                          block=4, **KW)
    to, tc = TL.attention(tp, torch.from_numpy(x), cache=tc,
                          sliding_window=3, block=4, **KW)
    _close(to, jo)
    jc = dict(jc, len=jnp.asarray(np.array([7, 11], np.int32)))
    tc = dict(tc, len=torch.tensor([7, 11], dtype=torch.int32))
    for step in range(3):
        xt = _rand((2, 1, 32), 61 + step)
        jo, jc = JL.attention(jp, jnp.asarray(xt), cache=jc,
                              sliding_window=3, **KW)
        to, tc = TL.attention(tp, torch.from_numpy(xt), cache=tc,
                              sliding_window=3, **KW)
        _close(to, jo)
        _same_cache(tc, jc)


@pytest.mark.parametrize("lens", [9, [3, 12, 7]])
def test_decode_attention_with_a_window_matches(lens):
    B, S, H, K, hd = 3, 12, 6, 2, 8
    q = _rand((B, 1, H, hd), 70)
    kc, vc = _rand((B, S, K, hd), 71), _rand((B, S, K, hd), 72)
    ln = np.asarray(lens, np.int32)
    want = JL.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(ln),
                               sliding_window=4)
    got = TL.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                              torch.from_numpy(vc), torch.from_numpy(ln),
                              sliding_window=4)
    _close(got, want)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_matches(act):
    """fp32 against JAX; bf16 against the port's own fp32 output (two
    bf16-rounded products and an activation: 2e-2, some 10 units of bf16's
    roundoff 2^-9), never against JAX's bf16."""
    jp = JL.init_mlp(jax.random.PRNGKey(3), 32, 48, act)
    tp = {n: torch.from_numpy(np.array(a)) for n, a in jp.items()}
    x = _rand((2, 5, 32), 80)
    full = TL.mlp(tp, torch.from_numpy(x), act)
    _close(full, JL.mlp(jp, jnp.asarray(x), act))
    t = TL.init_mlp(torch.Generator().manual_seed(0), 32, 48, act,
                    torch.bfloat16)
    assert {n: (tuple(v.shape), v.dtype) for n, v in t.items()} == {
        n: (tuple(a.shape), torch.bfloat16) for n, a in jp.items()}
    xb = torch.from_numpy(x).bfloat16()
    got = TL.mlp({n: v.bfloat16() for n, v in tp.items()}, xb, act)
    assert got.dtype == torch.bfloat16
    _close(got, full.numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_glu_act_matches(act):
    h = _rand((3, 5, 16), 13)
    _close(TL.glu_act(torch.from_numpy(h), act),
           JL.glu_act(jnp.asarray(h), act))
