"""Transformer layer primitives — counterpart of ``repro.models.layers``.

Plain functions over explicit parameter dicts, as in the JAX package:

* activations ``[batch, seq, d_model]``; attention heads ``[B, S, H, hd]``;
* parameters come from ``init_*`` functions, which draw from an explicit
  ``torch.Generator`` and create tensors on that generator's device
  (``randn``; on the meta device, ``MetaDraws`` stands in for the
  generator and nothing is drawn);
* attention over a prompt is computed blockwise over KV (online softmax), so
  the full ``S×S`` score matrix never materializes.

Sliding-window layers keep a ring-buffer cache of W slots (``attention``),
as the JAX functions do.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel.ctx import (current_cache_blocks, current_flash_decode,
                            current_tensor_parallel)


class MetaDraws:
    """The ``gen`` of the ``init_*`` functions on the meta device, where no
    ``torch.Generator`` can be made: its tensors have shapes and dtypes and
    no values (``launch/dryrun.py`` counts a step's work on them)."""

    device = torch.device("meta")


def randn(gen, shape):
    """Standard normal draws of ``shape`` from ``gen`` on its device; an
    empty tensor for ``MetaDraws``."""
    if isinstance(gen, MetaDraws):
        return torch.empty(shape, device=gen.device)
    return torch.randn(shape, generator=gen, device=gen.device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x, w, eps=1e-6):
    dt = x.dtype
    x = x.float()
    y = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (y * (1.0 + w.float())).to(dt)


def layer_norm(x, w, b, eps=1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    if w is not None:
        y = y * w.float()
    if b is not None:
        y = y + b.float()
    return y.to(dt)


def nonparam_ln(x, eps=1e-5):
    """OLMo-style non-parametric LayerNorm (no scale, no bias)."""
    return layer_norm(x, None, None, eps)


def apply_norm(kind: str, x, p, name: str):
    if kind == "rmsnorm":
        return rms_norm(x, p[name])
    if kind == "layernorm":
        return layer_norm(x, p[name], p.get(name + "_b"))
    if kind == "nonparam_ln":
        return nonparam_ln(x)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-split rotation, not interleaved)
# ---------------------------------------------------------------------------


def rope_tables(positions, head_dim: int, theta: float):
    """cos/sin tables [..., head_dim/2] for given integer positions."""
    half = head_dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (idx / half))
    ang = positions.float()[..., None] * freqs                # [..., half]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: [B, S, H, hd]; cos/sin: [B, S, hd/2] (or broadcastable)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ---------------------------------------------------------------------------
# Blockwise (flash-style) attention — online softmax over KV blocks.
# ---------------------------------------------------------------------------


def _attn_block(q, k, v, mask, scale):
    """One KV block: returns (scores_max, exp_sum, weighted_v) in fp32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    s = torch.where(mask, s, -1e30)
    m = torch.amax(s, dim=-1)                                 # [B,H,Q]
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)                                  # noqa: E741
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return m, l, o.float()


def blockwise_attention(q, k, v, *, causal: bool, q_offset,
                        sliding_window: int = 0, block: int = 1024,
                        scale: Optional[float] = None):
    """Online-softmax attention, O(S·block) memory.

    q: [B, Sq, H, hd]; k/v: [B, Sk, K, hd] with K | H (GQA: query head h
    reads kv head h // (H/K)). ``q_offset`` is the absolute position of q[0]
    relative to k[0]. A Python loop over KV blocks replaces the JAX scan; the
    last block is not padded, since masked keys add exactly 0 to the sums.
    """
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if K != H:
        rep = H // K
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    q_pos = q_offset + torch.arange(Sq, device=q.device)      # [Sq]

    def body(m_acc, l_acc, o_acc, kb, vb, start):
        """One KV block's mask, scores and online-softmax update."""
        k_pos = start + torch.arange(kb.shape[1], device=q.device)
        mask = torch.ones((Sq, kb.shape[1]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if sliding_window:
            mask &= q_pos[:, None] - k_pos[None, :] < sliding_window
        m, l, o = _attn_block(q, kb, vb, mask[None, None], scale)  # noqa: E741
        m_new = torch.maximum(m_acc, m)
        c_old = torch.exp(m_acc - m_new)
        c_new = torch.exp(m - m_new)
        l_new = l_acc * c_old + l * c_new
        o_new = (o_acc * c_old[..., None].transpose(1, 2)
                 + o * c_new[..., None].transpose(1, 2))
        return m_new, l_new, o_new

    # While autograd records, each block runs under its own checkpoint, as
    # JAX's jax.checkpoint(body): the backward recomputes a block's fp32
    # scores and probabilities instead of keeping every block's. Without
    # grad (serving) the body runs directly.
    remat = torch.is_grad_enabled() and any(t.requires_grad
                                            for t in (q, k, v))
    m_acc = torch.full((B, H, Sq), -1e30, dtype=torch.float32,
                       device=q.device)
    l_acc = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    o_acc = torch.zeros((B, Sq, H, hd), dtype=torch.float32, device=q.device)
    for start in range(0, Sk, block):
        args = (m_acc, l_acc, o_acc, k[:, start:start + block],
                v[:, start:start + block], start)
        m_acc, l_acc, o_acc = (checkpoint(body, *args, use_reentrant=False)
                               if remat else body(*args))
    denom = l_acc.transpose(1, 2)[..., None]                  # [B,Sq,H,1]
    return (o_acc / torch.clamp(denom, min=1e-30)).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     sliding_window: int = 0,
                     scale: Optional[float] = None):
    """Single-token attention against a KV cache.

    q: [B, 1, H, hd]; caches: [B, S, K, hd]; ``cache_len`` a scalar or [B]
    tensor of valid positions. Query head h reads kv head h // (H/K).
    ``sliding_window`` masks keys older than the window.
    """
    B, _, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, 1, K, H // K, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache)
    s = s.float() * scale
    pos = torch.arange(S, device=q.device)
    lens = torch.as_tensor(cache_len, device=q.device)
    if lens.dim() == 0:                                       # uniform batch
        lens = lens.expand(B)
    mask = pos[None, :] < lens[:, None]                       # [B, S]
    if sliding_window:
        mask &= pos[None, :] >= lens[:, None] - sliding_window
    s = torch.where(mask[:, None, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(B, 1, H, hd)


# ---------------------------------------------------------------------------
# Attention layer (GQA/MQA, optional bias, RoPE, KV cache)
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, d_model, n_heads, n_kv_heads,
                   head_dim, qkv_bias=False, dtype=torch.float32):
    """Weights drawn in fp32 from ``gen`` on its device, kept in ``dtype``."""
    std = d_model ** -0.5

    def normal(*shape):
        return (randn(gen, shape) * std).to(dtype)

    p = {
        "wq": normal(d_model, n_heads * head_dim),
        "wk": normal(d_model, n_kv_heads * head_dim),
        "wv": normal(d_model, n_kv_heads * head_dim),
        "wo": normal(n_heads * head_dim, d_model),
    }
    if qkv_bias:
        for name, n in (("bq", n_heads), ("bk", n_kv_heads),
                        ("bv", n_kv_heads)):
            p[name] = torch.zeros(n * head_dim, dtype=dtype,
                                  device=gen.device)
    return p


def attention(p, x, *, n_heads, n_kv_heads, head_dim, rope_theta,
              causal=True, sliding_window=0, block=1024, cache=None,
              flash_decode=None, cache_slots=None):
    """Returns (out, new_cache). ``cache`` = dict(k, v, len) for serving.

    Unlike the JAX function, which returns fresh cache arrays, the port
    writes the new keys and values into ``cache["k"]``/``cache["v"]`` in
    place (no copy of the cache per token); ``len`` is a new tensor.
    ``flash_decode``: an impl of ``parallel.flash_decode.make_flash_decode``
    for one-token decode with a scalar length; without one, the ambient
    ``parallel.ctx.flash_decode_context``'s. Where it returns ``None`` the
    dense path runs.

    Under an ambient ``parallel.tp.TensorParallel`` ``p`` holds the rank's
    column blocks of ``wq``/``wk``/``wv`` and row block of ``wo``: the
    residual ``x`` enters as the group's whole sequence, the rank runs its
    H/M query and K/M kv heads at their global positions, and its partial
    output leaves summed over the ranks. Where the heads do not split
    (``H % M``), ``wq``/``bq``/``wo`` arrive whole
    (``TensorParallel.layer``) and the rank runs its ⌈H/M⌉ or ⌊H/M⌋ heads
    (none, on a rank past the H-th: its output is zeros, its transfers the
    others'). Where the kv heads do not split (``K % M``), ``wk``/``wv``
    arrive whole, the rank computes the kv heads its query heads read, and
    each of its query heads reads its group's
    (``TensorParallel.attention_params``).

    With a cache on a process mesh (an ambient
    ``parallel.tp.CacheBlocks``, in any mode) ``cache`` holds the rank's
    blocks: every kv head over its block of the ``cache_slots`` slots of
    the whole cache (:func:`_block_cache_attention`). Without one, a cache
    runs the one-process path.
    """
    tp = current_tensor_parallel()
    cb = current_cache_blocks() if cache is not None else None
    if cache is not None and cb is None:
        tp = None
    whole_p, H, K = p, n_heads, n_kv_heads
    kv_sel = None
    if tp is not None:
        x = tp.enter(x)
        p, n_heads, n_kv_heads, kv_sel = tp.attention_params(
            p, n_heads, n_kv_heads, head_dim)
    B, S, _ = x.shape
    compute_dtype = x.dtype

    ar = torch.arange(S, device=x.device)
    if cache is not None:
        # cache["len"]: scalar (uniform batched serving) or [B]
        # (continuous batching with per-slot positions).
        lens = cache["len"]
        if lens.dim() == 0:
            positions = (lens + ar)[None, :].expand(B, S)
        else:
            positions = lens[:, None] + ar[None, :]
    else:
        positions = ar[None, :].expand(B, S)
    rope = rope_tables(positions, head_dim, rope_theta) if rope_theta \
        else None

    def heads(w, b, n, rotate=True):
        """x's projection onto ``n`` heads, rotated at the positions."""
        y = x @ w.to(compute_dtype)
        if b is not None:
            y = y + b.to(compute_dtype)
        y = y.reshape(B, S, n, head_dim)
        return apply_rope(y, *rope) if rotate and rope is not None else y

    q = heads(p["wq"], p.get("bq"), n_heads)
    k = heads(p["wk"], p.get("bk"), n_kv_heads)
    v = heads(p["wv"], p.get("bv"), n_kv_heads, rotate=False)

    if cb is not None:
        def every_head(name, t):
            """``t``, the rank's heads of projection ``name`` (q, k or v),
            as all of them: gathered over ``model`` where they split, else
            projected from the whole leaf ``layer`` gathered."""
            if tp is None or tp.m == 1:
                return t
            n, split = ((H, not tp.uneven) if name == "q"
                        else (K, kv_sel is None))
            if split:
                return tp.comm.all_gather_dim(t, 2)
            return heads(whole_p["w" + name], whole_p.get("b" + name), n,
                         rotate=name != "v")
        o, new_cache = _block_cache_attention(
            cb, tp, q, k, v, kv_sel, cache, cache_slots, every_head,
            causal=causal, sliding_window=sliding_window, block=block,
            flash_decode=flash_decode, n_heads=H)
    else:
        if kv_sel is not None:
            sel = kv_sel.to(x.device)
            k, v = k.index_select(2, sel), v.index_select(2, sel)
        o, new_cache = _one_process_attention(
            q, k, v, cache, causal=causal, sliding_window=sliding_window,
            block=block, flash_decode=flash_decode)

    out = o.reshape(B, S, n_heads * head_dim) @ p["wo"].to(compute_dtype)
    if tp is not None:
        out = tp.leave(out)
    return out, new_cache


def _dense_decode(q, k, v, kc, vc, lens, sliding_window):
    """One token's attention over a whole cache ``kc``/``vc``, its K/V
    written at each slot's length in place (wrapped on a ring): the
    output [B, 1, H, hd]."""
    B, W = q.shape[0], kc.shape[1]
    # A window cache no larger than the window is a ring buffer: token
    # p lives in slot p % W.
    ring = bool(sliding_window) and W <= sliding_window
    # Elsewhere, as with the JAX dynamic_update_slice, the index is
    # clamped to the cache (slots that decode while idle run past
    # max_len).
    idx = lens % W if ring else torch.clamp(lens, max=W - 1)
    if lens.dim() == 0:
        # A one-element index: a 0-d one would read the length on the
        # host, which the meta device (the dry run) cannot.
        at = idx.reshape(1).long()
        kc.index_copy_(1, at, k)
        vc.index_copy_(1, at, v)
    else:
        rows = torch.arange(B, device=q.device)
        kc[rows, idx] = k[:, 0]
        vc[rows, idx] = v[:, 0]
    if ring:
        # Slot i holds the newest token at a position ≡ i (mod W), so
        # every written slot is inside the window: only slots not yet
        # written are masked (the JAX package's _ring_decode_attention).
        return decode_attention(q, kc, vc, torch.clamp(lens + 1, max=W))
    return decode_attention(q, kc, vc, lens + 1,
                            sliding_window=sliding_window)


def _one_process_attention(q, k, v, cache, *, causal, sliding_window,
                           block, flash_decode):
    """``attention``'s heads over the prompt, or with a cache in one
    process: (o [B, S, H, hd], new_cache)."""
    S = q.shape[1]
    if cache is None:
        return blockwise_attention(q, k, v, causal=causal, q_offset=0,
                                   sliding_window=sliding_window,
                                   block=block), None
    kc, vc, lens = cache["k"], cache["v"], cache["len"]
    W = kc.shape[1]
    if S == 1:
        fd = flash_decode if flash_decode is not None \
            else current_flash_decode()
        res = None
        if fd is not None and lens.dim() == 0 and not sliding_window:
            res = fd(q, kc, vc, k, v, lens)
        if res is not None:
            o, kc, vc = res
        else:
            o = _dense_decode(q, k, v, kc, vc, lens, sliding_window)
        return o, {"k": kc, "v": vc, "len": lens + 1}
    # Prefill into an empty cache. A cache smaller than the prompt
    # keeps the last W keys at their ring slots: element j of the
    # last-W slice holds position S-W+j, slot (j + S) % W.
    if W < S:
        kc.copy_(torch.roll(k[:, -W:], S % W, dims=1))
        vc.copy_(torch.roll(v[:, -W:], S % W, dims=1))
    else:
        kc[:, :S] = k
        vc[:, :S] = v
    o = blockwise_attention(q, k, v, causal=causal, q_offset=0,
                            sliding_window=sliding_window, block=block)
    return o, {"k": kc, "v": vc, "len": lens + S}


def _slot_content(t, W):
    """A prompt's keys or values ``t`` [B, S, k, hd] as the W slots of an
    empty cache: positions 0..S-1 then zeros, or, where the prompt is
    longer than a ring of W, its last W at their slots p % W."""
    S = t.shape[1]
    if W < S:
        return torch.roll(t[:, -W:], S % W, dims=1)
    return F.pad(t, (0, 0, 0, 0, 0, W - S))


def _block_cache_attention(cb, tp, q, k, v, kv_sel, cache, W, every_head,
                           *, causal, sliding_window, block, flash_decode,
                           n_heads):
    """Attention with a process's cache blocks (``parallel.tp.CacheBlocks``)
    of a cache of ``W`` slots: every kv head over the rank's block of the
    slots. ``q``, ``k``, ``v``: the rank's heads (its own under tensor
    parallelism, every head otherwise); ``every_head(name, t)`` gives all
    of them from them. Returns (o over the rank's query heads, the new
    cache).

    A prompt runs the rank's heads over it as training does; the cache
    takes its kv heads' slots: the rank's block of every head's, cut from
    the whole where the rank computes every head, else one all-to-all of
    its heads for the other ranks' blocks (``CacheBlocks.exchange``). A
    decode step gathers the token's query and kv heads: flash decoding
    over the slot blocks writes the token at its owner and combines the
    partials over ``model``; the ring of a windowed layer, and any layer
    without flash decoding, gathers its blocks whole, runs the one-process
    decode, and keeps its block of the written cache. Under tensor
    parallelism the rank's heads of the output are kept."""
    kc, vc, lens = cache["k"], cache["v"], cache["len"]
    S = q.shape[1]
    if S > 1:
        ks, vs = k, v
        if kv_sel is not None:
            sel = kv_sel.to(q.device)
            ks, vs = k.index_select(2, sel), v.index_select(2, sel)
        o = blockwise_attention(q, ks, vs, causal=causal, q_offset=0,
                                sliding_window=sliding_window, block=block)
        for c, name, t in ((kc, "k", k), (vc, "v", v)):
            if tp is not None and kv_sel is None and tp.m > 1:
                c.copy_(cb.exchange(_slot_content(t, W)))
            else:
                c.copy_(cb.block(_slot_content(every_head(name, t), W), 1))
        return o, {"k": kc, "v": vc, "len": lens + S}
    qa, ka, va = (every_head(n, t) for n, t in (("q", q), ("k", k),
                                                  ("v", v)))
    fd = flash_decode if flash_decode is not None else current_flash_decode()
    if fd is not None and cb.splits(W) and lens.dim() == 0 \
            and not sliding_window:
        o = fd(qa, kc, vc, ka, va, lens)[0]
    else:
        kw, vw = cb.whole(kc, 1, W), cb.whole(vc, 1, W)
        o = _dense_decode(qa, ka, va, kw, vw, lens, sliding_window)
        if kw is not kc:
            kc.copy_(cb.block(kw, 1))
            vc.copy_(cb.block(vw, 1))
    if tp is not None and tp.m > 1:
        lo, hi = tp.head_range(n_heads)
        o = o[:, :, lo:hi]
    return o, {"k": kc, "v": vc, "len": lens + 1}


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU fused-gate, or plain GELU)
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d_model, d_ff, act, dtype=torch.float32):
    """Weights drawn in fp32 from ``gen`` on its device, kept in ``dtype``:
    ``w_in`` [d, 2F] for a gated activation ([d, F] for gelu), ``w_down``
    [F, d]."""
    cols = 2 * d_ff if act in ("swiglu", "geglu") else d_ff

    def normal(shape, std):
        return (randn(gen, shape) * std).to(dtype)

    return {"w_in": normal((d_model, cols), d_model ** -0.5),
            "w_down": normal((d_ff, d_model), d_ff ** -0.5)}


def glu_act(h, act: str):
    f = h.shape[-1] // 2
    a, b = h[..., :f], h[..., f:]
    if act == "swiglu":
        return F.silu(a) * b
    if act == "geglu":
        return F.gelu(a, approximate="tanh") * b
    raise ValueError(act)


def mlp(p, x, act: str):
    """The dense FFN: x·w_in → GLU (or tanh-approximated GELU) → ·w_down,
    plain ``torch.matmul`` in x's dtype.

    Under an ambient ``parallel.tp.TensorParallel`` ``p`` holds the rank's
    column block of ``w_in`` and row block of ``w_down``: the residual
    enters as the group's whole sequence, a GLU's block is exchanged into
    the rank's gate and up blocks (``glu_pair``; GELU's lines up as it
    is), and the partial output leaves summed over the ranks."""
    tp = current_tensor_parallel()
    if tp is not None:
        x = tp.enter(x)
    dt = x.dtype
    h = x @ p["w_in"].to(dt)
    if act in ("swiglu", "geglu"):
        h = glu_act(h if tp is None else tp.glu_pair(h), act)
    else:
        h = F.gelu(h, approximate="tanh")
    out = h @ p["w_down"].to(dt)
    return out if tp is None else tp.leave(out)
