"""Models from a ModelConfig: init / forward / loss / prefill / decode —
counterpart of ``repro.models.model``.

``ModelConfig`` keeps every field of the JAX dataclass, so configs compare
field by field. The port runs all six families: dense, moe, ssm, hybrid,
audio (an encoder over ``features`` frames through ``feat_proj``, no
decode) and vlm (precomputed ``patches`` embeddings before the tokens; the
logits cover the token region only). Parameters are plain dicts, one dict per
layer: ``params["blocks"]`` is a list of them (the JAX tree stacks them as
``[L, ...]`` for ``scan``; here a Python loop runs the layers). A hybrid
stack mirrors the JAX layout: ``params["super"]`` is a tuple over the
pattern's positions, each a list of the super-blocks' layer dicts, and
``params["tail"]`` the list of the layers past the last whole super-block;
its cache takes the same ``{"super", "tail"}`` shape.

The MoE block defaults to ``moe_grouped`` with ``gmm_fn=ops.moe_expert_ffn``,
the JAX package's kernel-backed configuration: on the card every MoE block
launches the ``gmm_swiglu`` and ``gmm`` kernels. ``loss_fn`` takes the
trainable variant, whose backward launches ``gmm_swiglu_bwd`` and ``gmm``.
The dense MLP, the SSD scan and the RG-LRU scan are plain PyTorch, as they
are plain JAX in the reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from functools import partial
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..kernels import ops
from ..parallel.ctx import (current_cache_blocks, current_moe_impl,
                            current_tensor_parallel, tensor_parallel_context)
from . import layers as L
from .moe import MoEConfig, init_moe, moe_grouped
from .rglru import init_rglru, rglru_block
from .ssm import SSMConfig, init_ssm, ssm_forward

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    head_dim: int = 0             # 0 → d_model // n_heads
    act: str = "swiglu"           # swiglu | geglu | gelu
    norm: str = "rmsnorm"         # rmsnorm | layernorm | nonparam_ln
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    causal: bool = True
    sliding_window: int = 0
    embed_scale: bool = False     # gemma-style sqrt(d) embedding scaling
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_pattern: tuple = ()    # e.g. ("rglru", "rglru", "local_attn")
    lru_width: int = 0
    feat_in: int = 0              # audio frontend feature width (stub)
    n_patches: int = 0            # vlm patch-prefix length (stub)
    vocab_pad: int = 256
    dtype: str = "bfloat16"
    # Training: ``remat`` recomputes each layer in the backward; policy
    # "full" recomputes the whole block, "save_moe" keeps each block's MoE
    # output so the backward never re-runs the MoE (``_run_stack``). The
    # others are kept so configs compare field by field.
    remat: bool = True
    remat_policy: str = "full"
    scan_layers: bool = True
    attn_block: int = 1024        # KV block for blockwise attention

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    @property
    def padded_vocab(self) -> int:
        return int(math.ceil(self.vocab / self.vocab_pad) * self.vocab_pad)

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def layer_types(self) -> list[str]:
        if self.family in ("dense", "audio", "vlm"):
            return ["attn"] * self.n_layers
        if self.family == "moe":
            return ["attn_moe"] * self.n_layers
        if self.family == "ssm":
            return ["ssm"] * self.n_layers
        if self.family == "hybrid":
            pat = list(self.hybrid_pattern)
            out = []
            while len(out) < self.n_layers:
                out.extend(pat)
            return out[:self.n_layers]
        raise ValueError(self.family)

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline bookkeeping)."""
        d, f, V = self.d_model, self.d_ff, self.padded_vocab
        n = V * d  # embed
        if not self.tie_embeddings:
            n += d * V
        glu = 3 if self.act in ("swiglu", "geglu") else 2
        for t in self.layer_types():
            if t in ("attn", "attn_moe", "local_attn"):
                n += d * (self.n_heads + 2 * self.n_kv_heads) * self.hd
                n += self.n_heads * self.hd * d
            if t in ("attn", "local_attn", "rglru"):
                n += glu * d * f
            if t == "attn_moe":
                m = self.moe
                n += d * m.e_total + m.e_total * 3 * d * m.d_expert
            if t == "ssm":
                s = self.ssm
                d_in = s.expand * d
                H = s.n_heads(d)
                n += d * (2 * d_in + 2 * s.d_state + H) + d_in * d
            if t == "rglru":
                w = self.lru_width or d
                n += 2 * d * w + 2 * w * w + w * d
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k of experts)."""
        if self.family != "moe":
            return self.param_count()
        m = self.moe
        full = self.param_count()
        expert_p = self.n_layers * m.e_total * 3 * self.d_model * m.d_expert
        active_e = self.n_layers * m.top_k * 3 * self.d_model * m.d_expert
        return full - expert_p + active_e


def _hybrid_split(cfg: ModelConfig) -> tuple[int, int]:
    """(pattern length, whole super-blocks) of a hybrid stack."""
    pat = len(cfg.hybrid_pattern)
    return pat, cfg.n_layers // pat


def _hybrid_tree(cfg: ModelConfig, layers: list) -> dict:
    """Per-layer entries (params or caches) in the JAX hybrid layout:
    ``super``, a tuple over the pattern's positions of the super-blocks'
    entries, and ``tail``, the layers after the last whole super-block."""
    pat, n_super = _hybrid_split(cfg)
    return {"super": tuple([layers[g * pat + pos] for g in range(n_super)]
                           for pos in range(pat)),
            "tail": layers[n_super * pat:]}


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _norm_leaves(cfg: ModelConfig, names, dev) -> dict:
    """The norm scales (and layernorm biases) ``names``, fp32. rmsnorm
    scales by 1 + w, so its w starts at 0, as in the reference; layernorm
    scales by w, which starts at 1 here. The reference starts it at 0 too,
    which zeroes every layernorm's output (ROADMAP §3)."""
    p = {}
    if cfg.norm == "nonparam_ln":
        return p
    for name in names:
        p[name] = (torch.ones if cfg.norm == "layernorm" else torch.zeros)(
            cfg.d_model, device=dev)
        if cfg.norm == "layernorm":
            p[name + "_b"] = torch.zeros(cfg.d_model, device=dev)
    return p


def _init_block(cfg: ModelConfig, btype: str, gen: torch.Generator) -> dict:
    dt, d = cfg.compute_dtype, cfg.d_model
    p: dict = {}
    if btype in ("attn", "attn_moe", "local_attn"):
        p["attn"] = L.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.hd, cfg.qkv_bias, dt)
    if btype in ("attn", "local_attn"):
        p["mlp"] = L.init_mlp(gen, d, cfg.d_ff, cfg.act, dt)
    if btype == "attn_moe":
        p["moe"] = init_moe(gen, d, cfg.moe, dt)
    if btype == "ssm":
        p["ssm"] = init_ssm(gen, d, cfg.ssm, dt)
    if btype == "rglru":
        p["rglru"] = init_rglru(gen, d, cfg.lru_width or d, 4, dt)
        p["mlp"] = L.init_mlp(gen, d, cfg.d_ff, cfg.act, dt)
    p.update(_norm_leaves(cfg, ("ln1", "ln2"), gen.device))
    return p


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, device="cuda") -> dict:
    """Random parameters on ``device`` from ``generator`` (default: seed 0).

    Matrices are stored in the config's compute dtype; the norm scales, the
    router and the leaves the reference reads in fp32 (ssm's ``A_log`` and
    ``dt_bias``; rglru's gates and Λ) in fp32. The JAX package keeps
    fp32 masters and casts them at each use; casting once here gives the
    same values at every use. On ``device="meta"`` the leaves have their
    shapes and dtypes and no values (``layers.MetaDraws``): a generator
    cannot live there.
    """
    dev = resolve_device(device)
    if dev.type == "meta":
        if generator is not None:
            raise ValueError("the meta device draws nothing: pass no "
                             "generator")
        gen = L.MetaDraws()
    else:
        gen = generator if generator is not None else \
            torch.Generator(device=dev).manual_seed(0)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, params on {dev}")
    dt = cfg.compute_dtype
    V, d = cfg.padded_vocab, cfg.d_model

    def normal(*shape, std):
        return (L.randn(gen, shape) * std).to(dt)

    params: dict = {"embed": normal(V, d, std=d ** -0.5)}
    if cfg.family == "audio":
        params["feat_proj"] = normal(cfg.feat_in, d, std=cfg.feat_in ** -0.5)
    if not cfg.tie_embeddings:
        params["unembed"] = normal(d, V, std=d ** -0.5)
    params.update(_norm_leaves(cfg, ("ln_f",), dev))
    blocks = [_init_block(cfg, t, gen) for t in cfg.layer_types()]
    if cfg.family == "hybrid":
        params.update(_hybrid_tree(cfg, blocks))
    else:
        params["blocks"] = blocks
    return params


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def default_moe_impl(cfg: ModelConfig) -> Callable:
    """The kernel-backed MoE: grouped dispatch + the Hopper kernels."""
    return partial(moe_grouped, act=cfg.act, gmm_fn=ops.moe_expert_ffn)


def train_moe_impl(cfg: ModelConfig) -> Callable:
    """The kernel-backed MoE with the kernels' backward (``loss_fn``)."""
    return partial(moe_grouped, act=cfg.act,
                   gmm_fn=partial(ops.moe_expert_ffn, trainable=True))


def _window(cfg: ModelConfig, btype: str) -> int:
    """The reference's rule: a ``local_attn`` block takes the window; any
    other attention block does too, unless the family is hybrid."""
    if btype == "local_attn" or cfg.family != "hybrid":
        return cfg.sliding_window
    return 0


def _attn_half(cfg: ModelConfig, p, x, cache=None, flash_decode=None,
               btype: str = "attn_moe"):
    """ln1 → attention → residual: (x, new_cache)."""
    cb = current_cache_blocks() if cache is not None else None
    a, new_cache = L.attention(
        _part(p, "attn"), L.apply_norm(cfg.norm, x, p, "ln1"),
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        rope_theta=cfg.rope_theta, causal=cfg.causal,
        sliding_window=_window(cfg, btype), block=cfg.attn_block,
        cache=cache, flash_decode=flash_decode,
        cache_slots=None if cb is None else cb.slots(btype))
    return x + a, new_cache


def _moe_half(cfg: ModelConfig, p, x, moe_impl: Optional[Callable] = None):
    """ln2 → MoE → residual: ``moe_impl``, else the ambient
    ``parallel.ctx.moe_impl_context``'s, else the kernels."""
    h = L.apply_norm(cfg.norm, x, p, "ln2")
    impl = moe_impl or current_moe_impl() or default_moe_impl(cfg)
    tp = current_tensor_parallel()
    if tp is None:
        return x + impl(p["moe"], h, cfg.moe)
    moe = _part(p, "moe")
    return x + tp.moe(lambda r: impl(moe, r, cfg.moe), h)


def _part(p, part: str):
    """A layer's ``part`` params, placed by the ambient tensor
    parallelism's ``layer`` (its FSDP and whole-leaf gathers)."""
    tp = current_tensor_parallel()
    return p[part] if tp is None else tp.layer(p[part], part)


def _mlp_half(cfg: ModelConfig, p, x):
    """ln2 → MLP → residual."""
    return x + L.mlp(_part(p, "mlp"), L.apply_norm(cfg.norm, x, p, "ln2"),
                     cfg.act)


def block_apply(cfg: ModelConfig, btype: str, p, x, cache=None,
                moe_impl: Optional[Callable] = None, flash_decode=None):
    """One residual block. Returns (x, new_cache)."""
    if btype in ("attn", "attn_moe", "local_attn"):
        x, new_cache = _attn_half(cfg, p, x, cache, flash_decode, btype)
        if btype == "attn_moe":
            return _moe_half(cfg, p, x, moe_impl), new_cache
        return _mlp_half(cfg, p, x), new_cache
    if btype == "ssm":
        y, new_cache = ssm_forward(
            _part(p, "ssm"), L.apply_norm(cfg.norm, x, p, "ln1"), cfg.ssm,
            cache)
        return x + y, new_cache
    if btype == "rglru":
        y, new_cache = rglru_block(
            _part(p, "rglru"), L.apply_norm(cfg.norm, x, p, "ln1"), cache)
        return _mlp_half(cfg, p, x + y), new_cache
    raise ValueError(btype)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


class _Lookup(torch.autograd.Function):
    """``table[tokens]``, whose backward sums each row's grads in fp32 and
    rounds them to the table's dtype once. Indexing's own backward adds
    into the table's dtype, so a bf16 table rounds after every repeat of a
    token, and a frequent token's grad stops growing (PERF.md §6).
    In fp32 the two are the same op. The fp32 sums take one row a distinct
    token of the batch, not one a row of the table, and are found without
    reading the count of distinct tokens back to the host."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.shape, ctx.dtype = table.shape, table.dtype
        return table[tokens]

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        tok = tokens.reshape(-1)
        g = g.reshape(-1, ctx.shape[-1])
        # Each token's place among the batch's distinct tokens, in order.
        srt, order = torch.sort(tok)
        run = torch.cumsum(srt[1:] != srt[:-1], 0)
        run = torch.cat([run.new_zeros(1), run])
        inv = torch.empty_like(run).scatter_(0, order, run)
        acc = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        acc.index_put_((inv,), g.float(), accumulate=True)
        out = torch.zeros(ctx.shape, dtype=ctx.dtype, device=g.device)
        # A token's repeats write its one sum.
        return out.index_put_((tok,), acc[inv].to(ctx.dtype)), None


def _tp_lookup(tp, table, tokens, patches=None):
    """The residual's embeddings under tensor parallelism: each rank looks
    up the group's tokens in its vocabulary block (zeros for the others'),
    summed over the ranks; a table the vocabulary does not split looks up
    the rank's own tokens. A vlm batch's ``patches`` [b, P, d] (every rank
    holds its group's whole) go before the tokens over the group's whole
    sequence, of which the rank keeps its chunk: in the ranks' sum they
    are rank 0's addend, the others add zeros."""
    if not tp.split_vocab:
        if patches is None:
            return _Lookup.apply(table,
                                 tokens if tp.seq else tp.tokens(tokens))
        return tp.local(torch.cat(
            [patches, _Lookup.apply(table, tp.tokens(tokens))], dim=1))
    local = tp.tokens(tokens) - tp.vocab_lo(table.shape[0])
    inside = (local >= 0) & (local < table.shape[0])
    x = _Lookup.apply(table, torch.where(inside, local, 0))
    x = x * inside[..., None].to(x.dtype)
    if patches is not None:
        x = torch.cat([patches if tp.rank == 0 else
                       torch.zeros_like(patches), x], dim=1)
    return tp.leave(x)


def _n_patches(cfg: ModelConfig, batch) -> int:
    """The patch-prefix length of a vlm batch (0 without patches)."""
    if cfg.family == "vlm" and "patches" in batch:
        return batch["patches"].shape[1]
    return 0


def embed_inputs(cfg: ModelConfig, params, batch):
    """The stack's input: ``features`` [B, S, feat_in] through ``feat_proj``
    (audio), else the token embeddings, with a vlm batch's ``patches``
    [B, P, d] before them.

    Under tensor parallelism the residual: the rank's ``features`` (its
    frame chunk; without sequence parallelism gathered over the group's
    sequence first), or the vocabulary-parallel lookup, with the patches
    before the tokens and the rank's chunk of the P + S positions."""
    dt = cfg.compute_dtype
    tp = current_tensor_parallel()
    if cfg.family == "audio":
        f = batch["features"]
        if tp is not None and not tp.seq:
            f = tp.tokens(f)
        x = torch.einsum("bsf,fd->bsd", f.to(dt), params["feat_proj"].to(dt))
    elif tp is not None:
        P = _n_patches(cfg, batch)
        if tp.seq and P % tp.m:
            # The rank's tokens are its chunk of S, which M divides.
            raise ValueError(f"{P} patches and the tokens (P + S) do not "
                             f"split over the {tp.m} ranks of the model "
                             f"axis")
        x = _tp_lookup(tp, params["embed"].to(dt), batch["tokens"],
                       batch["patches"].to(dt) if P else None)
    else:
        x = _Lookup.apply(params["embed"].to(dt), batch["tokens"])
        if _n_patches(cfg, batch):
            x = torch.cat([batch["patches"].to(dt), x], dim=1)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _run_hybrid(cfg: ModelConfig, params, x, caches=None, moe_impl=None,
                flash_decode=None):
    """The hybrid stack: each super-block runs the pattern's blocks in
    order, then the tail's layers run one by one. With ``cfg.remat`` and
    autograd recording, each super-block runs under one non-reentrant
    ``checkpoint`` and the tail unchecked, as JAX checkpoints its scan body
    and not the unrolled tail."""
    pat, n_super = _hybrid_split(cfg)
    types = cfg.layer_types()
    remat = caches is None and cfg.remat and torch.is_grad_enabled()

    def super_block(h, g, cs=None):
        new = []
        for pos in range(pat):
            h, nc = block_apply(cfg, cfg.hybrid_pattern[pos],
                                params["super"][pos][g], h,
                                None if cs is None else cs[pos], moe_impl,
                                flash_decode)
            new.append(nc)
        return h, new

    new_sup = [[] for _ in range(pat)]
    for g in range(n_super):
        if remat:
            x = _remat(lambda h, g=g: super_block(h, g)[0], x)
            continue
        cs = (None if caches is None
              else [caches["super"][pos][g] for pos in range(pat)])
        x, new = super_block(x, g, cs)
        for pos in range(pat):
            new_sup[pos].append(new[pos])
    new_tail = []
    for i, bp in enumerate(params["tail"]):
        x, nc = block_apply(cfg, types[n_super * pat + i], bp, x,
                            None if caches is None else caches["tail"][i],
                            moe_impl, flash_decode)
        new_tail.append(nc)
    if caches is None:
        return x, None
    return x, {"super": tuple(new_sup), "tail": new_tail}


def _remat(fn, x):
    """``checkpoint(fn, x)`` (non-reentrant). Its recompute runs where
    autograd runs the backward (for CUDA tensors a thread of its own, where
    this thread's ambient tensor parallelism is unset), so it enters the
    forward's."""
    tp = current_tensor_parallel()
    if tp is None:
        return checkpoint(fn, x, use_reentrant=False)
    return checkpoint(fn, x, use_reentrant=False, context_fn=lambda: (
        contextlib.nullcontext(), tensor_parallel_context(tp)))


def _run_stack(cfg: ModelConfig, params, x, caches=None, moe_impl=None,
               flash_decode=None):
    """Apply all layers in a Python loop. caches: list of per-layer dicts (a
    hybrid stack: ``{"super", "tail"}``) or None.

    With ``cfg.remat`` and autograd recording, layers run under non-reentrant
    ``torch.utils.checkpoint`` (JAX: ``jax.checkpoint`` around the scan
    body). Policy "full" checkpoints the whole block, so the backward
    recomputes it. Policy "save_moe", and any ``moe_impl`` whose own
    backward recomputes what it needs (``moe_impl.self_remat``, the
    dropless fragment), checkpoint only the attention half of a MoE block:
    the MoE half runs once, outside the checkpoint, as JAX's remat keeps the
    MoE output (``save_moe``) or never re-runs the custom-vjp fragment's
    callback.
    """
    if cfg.family == "hybrid":
        return _run_hybrid(cfg, params, x, caches, moe_impl, flash_decode)
    btype = cfg.layer_types()[0]
    if caches is None and cfg.remat and torch.is_grad_enabled():
        split = btype == "attn_moe" and (
            cfg.remat_policy == "save_moe"
            or getattr(moe_impl, "self_remat", False))
        for bp in params["blocks"]:
            if split:
                x = _remat(lambda h, bp=bp: _attn_half(cfg, bp, h)[0], x)
                x = _moe_half(cfg, bp, x, moe_impl)
            else:
                x = _remat(lambda h, bp=bp: block_apply(
                    cfg, btype, bp, h, None, moe_impl)[0], x)
        return x, None
    new_caches = []
    for i, bp in enumerate(params["blocks"]):
        x, nc = block_apply(cfg, btype, bp, x,
                            None if caches is None else caches[i], moe_impl,
                            flash_decode)
        new_caches.append(nc)
    return x, (None if caches is None else new_caches)


def _unembedding(cfg: ModelConfig, params):
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


def _final(cfg: ModelConfig, params, x):
    x = L.apply_norm(cfg.norm, x, params, "ln_f")
    return x, _unembedding(cfg, params).to(x.dtype)


def forward(cfg: ModelConfig, params, batch, moe_impl=None):
    """Full forward → logits [B, S, Vp] (vlm: the token region only).
    Under tensor parallelism the group's logits whole: the vocabulary
    blocks and the sequence chunks gathered over ``model``."""
    x = final_hidden(cfg, params, batch, moe_impl)
    tp = current_tensor_parallel()
    if tp is not None and not _n_patches(cfg, batch):
        x = tp.whole_seq(x)        # (a vlm's comes back whole)
    logits = x @ _unembedding(cfg, params).to(x.dtype)
    return logits if tp is None else tp.vocab_whole(logits)


def final_hidden(cfg: ModelConfig, params, batch, moe_impl=None):
    """Forward to the final (pre-unembedding) hidden states; a vlm batch's
    patch region is cut off. Under tensor parallelism the residual's
    layout, but for a batch with patches: its token region over the
    group's whole sequence (the patches cut off after ``enter``)."""
    x = embed_inputs(cfg, params, batch)
    x, _ = _run_stack(cfg, params, x, None, moe_impl)
    x = L.apply_norm(cfg.norm, x, params, "ln_f")
    P = _n_patches(cfg, batch)
    if P:
        tp = current_tensor_parallel()
        x = (x if tp is None else tp.enter(x))[:, P:]
    return x


def _ce_chunk(cfg: ModelConfig, x, labels, unembed):
    """CE over one sequence chunk → (summed nll, token count), fp32; the
    logits exist only inside this function."""
    logits = (x @ unembed.to(x.dtype)).float()
    if cfg.padded_vocab != cfg.vocab:
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab
        logits = torch.where(pad[None, None, :], -1e30, logits)
    lse = torch.logsumexp(logits, dim=-1)
    # Labels < 0 are masked; clamp them so the gather stays in range.
    picked = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return torch.sum((lse - picked) * mask), torch.sum(mask)


def _ce_chunk_vocab(cfg: ModelConfig, tp, x, labels, unembed):
    """``_ce_chunk`` over the vocabulary blocks of tensor parallelism: the
    rank's logits ``x @ unembed`` (its block), the max, the sum of exps and
    the picked logit summed over the ranks; every rank then holds the
    group's sums."""
    logits = (x @ unembed.to(x.dtype)).float()
    block = logits.shape[-1]
    lo = tp.vocab_lo(block)
    if cfg.padded_vocab != cfg.vocab:
        pad = torch.arange(lo, lo + block, device=x.device) >= cfg.vocab
        logits = torch.where(pad[None, None, :], -1e30, logits)
    m = tp.vocab_max(torch.amax(logits, dim=-1))
    local = labels.clamp(min=0) - lo
    inside = (local >= 0) & (local < block)
    picked = torch.gather(logits, -1, local.clamp(0, block - 1)[..., None])
    stats = tp.vocab_sum(torch.stack([
        torch.sum(torch.exp(logits - m[..., None]), dim=-1),
        torch.where(inside, picked[..., 0], 0.0)]))
    lse = m + torch.log(stats[0])
    mask = (labels >= 0).float()
    return torch.sum((lse - stats[1]) * mask), torch.sum(mask)


def _chunked_ce(cfg: ModelConfig, x, labels, unembed, ce_chunk: int, ce):
    """``ce(x_c, l_c, unembed) -> (nll, count)`` over sequence chunks of at
    most ``ce_chunk``, each under ``checkpoint`` while autograd records;
    the sums."""
    S = x.shape[1]
    n = max(1, S // max(1, min(ce_chunk, S)))
    while S % n:
        n -= 1
    step = S // n
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        x_c, l_c = x[:, i * step:(i + 1) * step], labels[:, i * step:
                                                          (i + 1) * step]
        if torch.is_grad_enabled():
            nll_c, cnt_c = checkpoint(ce, x_c, l_c, unembed,
                                      use_reentrant=False)
        else:
            nll_c, cnt_c = ce(x_c, l_c, unembed)
        nll, cnt = nll + nll_c, cnt + cnt_c
    return nll, cnt


def loss_fn(cfg: ModelConfig, params, batch, moe_impl=None,
            ce_chunk: int = 512):
    """Next-token (or frame-label) cross entropy, fp32, vocab-pad masked.

    The MoE defaults to the ambient ``moe_impl_context``'s, else
    :func:`train_moe_impl`. The unembedding and logsumexp run in sequence
    chunks, each under ``checkpoint`` while autograd records, so the full
    [B, S, V] logits never materialize.

    Under tensor parallelism the loss is the data group's: each rank takes
    its vocabulary block's logits over the group's whole sequence, and the
    group's statistics make the same loss on every rank. A vocabulary the
    model axis does not split runs the plain cross entropy on the rank's
    sequence chunk, its sums added over the ranks.
    """
    x = final_hidden(cfg, params, batch, moe_impl or current_moe_impl()
                     or train_moe_impl(cfg))
    labels = batch["labels"]
    unembed = _unembedding(cfg, params)
    tp = current_tensor_parallel()
    # Under tensor parallelism a batch with patches comes back whole over
    # the group's sequence (``final_hidden``), the others as the residual.
    whole = bool(_n_patches(cfg, batch))
    if tp is None:
        nll, cnt = _chunked_ce(cfg, x, labels, unembed, ce_chunk,
                               partial(_ce_chunk, cfg))
    elif tp.split_vocab:
        nll, cnt = _chunked_ce(cfg, x if whole else tp.enter(x),
                               tp.tokens(labels), unembed, ce_chunk,
                               partial(_ce_chunk_vocab, cfg, tp))
    else:
        nll, cnt = tp.vocab_sum(torch.stack(_chunked_ce(
            cfg, tp.seq_chunk(x) if whole else tp.own_chunk(x), labels,
            unembed, ce_chunk, partial(_ce_chunk, cfg))))
    return nll / torch.clamp(cnt, min=1.0)


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def _block_cache(cfg: ModelConfig, btype: str, B: int, max_len: int,
                 per_slot_len: bool, dev) -> dict:
    dt = cfg.compute_dtype
    # The meta device holds no values: an empty leaf, which writes nothing
    # (a count of the dry run sees no work in it).
    make = torch.empty if dev.type == "meta" else torch.zeros

    def zeros(*shape, dtype=dt):
        return make(shape, dtype=dtype, device=dev)

    zlen = zeros(*((B,) if per_slot_len else ()), dtype=torch.int32)
    if btype in ("attn", "attn_moe", "local_attn"):
        W = max_len
        if btype == "local_attn":
            W = min(max_len, cfg.sliding_window or max_len)
        shp = (B, W, cfg.n_kv_heads, cfg.hd)
        return {"k": zeros(*shp), "v": zeros(*shp), "len": zlen}
    if btype == "ssm":
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        return {"conv": zeros(B, s.conv_width - 1, d_in + 2 * s.d_state),
                "ssm": zeros(B, s.n_heads(cfg.d_model), s.d_state,
                             s.head_dim)}
    if btype == "rglru":
        w = cfg.lru_width or cfg.d_model
        return {"conv": zeros(B, 3, w),
                "h": zeros(B, w, dtype=torch.float32)}
    raise ValueError(btype)


def init_cache(cfg: ModelConfig, B: int, max_len: int,
               per_slot_len: bool = False, *, device="cuda"):
    """One cache dict per layer: ``{"k", "v", "len"}`` for attention (a
    ``local_attn`` layer keeps a ring of min(max_len, window) slots),
    ``{"conv", "ssm"}`` for ssm, ``{"conv", "h"}`` for rglru. ``len`` is a
    scalar, or a [B] vector with ``per_slot_len`` (continuous batching). A
    hybrid stack's cache is ``{"super": tuple over pattern positions of
    per-super-block lists, "tail": list}``. On ``device="meta"`` it is the
    reference's ``cache_specs``: shapes and dtypes, no memory."""
    dev = resolve_device(device)
    caches = [_block_cache(cfg, t, B, max_len, per_slot_len, dev)
              for t in cfg.layer_types()]
    return _hybrid_tree(cfg, caches) if cfg.family == "hybrid" else caches


def decode_step(cfg: ModelConfig, params, token, cache, moe_impl=None,
                flash_decode=None):
    """token: [B, 1] → (logits [B, 1, Vp], new_cache).

    Attention keys and values are written into ``cache`` in place (see
    ``layers.attention``); the returned cache holds the new lengths and the
    new recurrent states. ``flash_decode``: the sharded one-token attention
    of ``parallel.flash_decode`` (scalar lengths, full-attention layers
    only).
    """
    x = embed_inputs(cfg, params, {"tokens": token})
    x, new_cache = _run_stack(cfg, params, x, cache, moe_impl, flash_decode)
    x, unembed = _final(cfg, params, x)
    tp = current_tensor_parallel()
    logits = x @ unembed
    return (logits if tp is None else tp.vocab_whole(logits)), new_cache


def prefill(cfg: ModelConfig, params, batch, max_len: int, moe_impl=None,
            cache=None):
    """Run the prompt through the stack, filling a new cache (``cache``:
    an empty one to fill, on a process mesh the rank's blocks).

    A vlm batch's ``patches`` go before the tokens and take the first
    cache slots, so ``max_len`` counts them. Returns (last-token logits
    [B, Vp], cache). An audio encoder has no cache: call ``forward``.
    Under tensor parallelism the last position comes from the rank whose
    sequence chunk holds it, and the logits are the whole vocabulary's.
    """
    tokens = batch["tokens"]
    if cache is None:
        cache = init_cache(cfg, tokens.shape[0], max_len,
                           device=tokens.device)
    x = embed_inputs(cfg, params, batch)
    x, new_cache = _run_stack(cfg, params, x, cache, moe_impl)
    x, unembed = _final(cfg, params, x)
    tp = current_tensor_parallel()
    if tp is None:
        return x[:, -1] @ unembed, new_cache
    return tp.vocab_whole(tp.last(x) @ unembed), new_cache
