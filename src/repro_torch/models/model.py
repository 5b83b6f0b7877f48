"""Models from a ModelConfig: init / forward / loss / prefill / decode —
counterpart of ``repro.models.model``.

``ModelConfig`` keeps every field of the JAX dataclass, so configs compare
field by field. The port runs the ``moe`` family (``attn_moe`` blocks); the
other families raise until their slice. Parameters are plain dicts with one
dict per layer in ``params["blocks"]`` (the JAX tree stacks them as
``[L, ...]`` for ``scan``; here a Python loop runs the layers).

The MoE block defaults to ``moe_grouped`` with ``gmm_fn=ops.moe_expert_ffn``,
the JAX package's kernel-backed configuration: on the card every MoE block
launches the ``gmm_swiglu`` and ``gmm`` kernels. ``loss_fn`` takes the
trainable variant, whose backward launches ``gmm_swiglu_bwd`` and ``gmm``.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..kernels import ops
from . import layers as L
from .moe import MoEConfig, init_moe, moe_grouped

_FAMILY_SLICE = {
    "dense": "the dense-family slice",
    "audio": "the audio/vlm slice",
    "vlm": "the audio/vlm slice",
    "ssm": "the ssm/hybrid slice",
    "hybrid": "the ssm/hybrid slice",
}


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
    ssm: Optional[object] = None  # SSM config; the ssm family is not ported
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
        """Analytic parameter count of the ported (moe) family."""
        _require_moe(self)
        d, V, m = self.d_model, self.padded_vocab, self.moe
        n = V * d if self.tie_embeddings else 2 * V * d
        per_layer = (d * (self.n_heads + 2 * self.n_kv_heads) * self.hd
                     + self.n_heads * self.hd * d
                     + d * m.e_total + m.e_total * 3 * d * m.d_expert)
        return n + self.n_layers * per_layer


def _require_moe(cfg: ModelConfig) -> None:
    if cfg.family != "moe":
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet; it comes with "
            f"{_FAMILY_SLICE.get(cfg.family, 'a later slice')}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, device="cuda") -> dict:
    """Random parameters on ``device`` from ``generator`` (default: seed 0).

    Matrices are stored in the config's compute dtype and the norm scales and
    router in fp32. The JAX package keeps fp32 masters and casts them at each
    use; casting once here gives the same values at every use.
    """
    _require_moe(cfg)
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, params on {dev}")
    dt = cfg.compute_dtype
    V, d = cfg.padded_vocab, cfg.d_model

    def normal(*shape, std):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dt)

    params: dict = {"embed": normal(V, d, std=d ** -0.5)}
    if not cfg.tie_embeddings:
        params["unembed"] = normal(d, V, std=d ** -0.5)
    params["ln_f"] = torch.zeros(d, device=dev)
    blocks = []
    for _ in range(cfg.n_layers):
        blocks.append({
            "attn": L.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.hd, cfg.qkv_bias, dt),
            "moe": init_moe(gen, d, cfg.moe, dt),
            "ln1": torch.zeros(d, device=dev),
            "ln2": torch.zeros(d, device=dev),
        })
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


def _attn_half(cfg: ModelConfig, p, x, cache=None):
    """ln1 → attention → residual: (x, new_cache)."""
    a, new_cache = L.attention(
        p["attn"], L.apply_norm(cfg.norm, x, p, "ln1"),
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        rope_theta=cfg.rope_theta, causal=cfg.causal,
        sliding_window=cfg.sliding_window, block=cfg.attn_block, cache=cache)
    return x + a, new_cache


def _moe_half(cfg: ModelConfig, p, x, moe_impl: Optional[Callable] = None):
    """ln2 → MoE → residual."""
    h = L.apply_norm(cfg.norm, x, p, "ln2")
    impl = moe_impl or default_moe_impl(cfg)
    return x + impl(p["moe"], h, cfg.moe)


def block_apply(cfg: ModelConfig, btype: str, p, x, cache=None,
                moe_impl: Optional[Callable] = None):
    """One residual block. Returns (x, new_cache)."""
    if btype != "attn_moe":
        raise NotImplementedError(
            f"{btype!r} blocks are not ported yet; the port runs attn_moe")
    x, new_cache = _attn_half(cfg, p, x, cache)
    return _moe_half(cfg, p, x, moe_impl), new_cache


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def embed_inputs(cfg: ModelConfig, params, batch):
    _require_moe(cfg)
    x = params["embed"].to(cfg.compute_dtype)[batch["tokens"]]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _run_stack(cfg: ModelConfig, params, x, caches=None, moe_impl=None):
    """Apply all layers in a Python loop. caches: list of per-layer dicts or
    None.

    With ``cfg.remat`` and autograd recording, layers run under non-reentrant
    ``torch.utils.checkpoint`` (JAX: ``jax.checkpoint`` around the scan
    body). Policy "full" checkpoints the whole block, so the backward
    recomputes it. Policy "save_moe", and any ``moe_impl`` whose own
    backward recomputes what it needs (``moe_impl.self_remat``, the
    dropless fragment), checkpoint only the attention half: the MoE half
    runs once, outside the checkpoint, as JAX's remat keeps the MoE output
    (``save_moe``) or never re-runs the custom-vjp fragment's callback.
    """
    btype = cfg.layer_types()[0]
    if caches is None and cfg.remat and torch.is_grad_enabled():
        split = (cfg.remat_policy == "save_moe"
                 or getattr(moe_impl, "self_remat", False))
        for bp in params["blocks"]:
            if split:
                x = checkpoint(lambda h, bp=bp: _attn_half(cfg, bp, h)[0],
                               x, use_reentrant=False)
                x = _moe_half(cfg, bp, x, moe_impl)
            else:
                x = checkpoint(
                    lambda h, bp=bp: block_apply(cfg, btype, bp, h, None,
                                                 moe_impl)[0],
                    x, use_reentrant=False)
        return x, None
    new_caches = []
    for i, bp in enumerate(params["blocks"]):
        x, nc = block_apply(cfg, btype, bp, x,
                            None if caches is None else caches[i], moe_impl)
        new_caches.append(nc)
    return x, (None if caches is None else new_caches)


def _unembedding(cfg: ModelConfig, params):
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


def _final(cfg: ModelConfig, params, x):
    x = L.apply_norm(cfg.norm, x, params, "ln_f")
    return x, _unembedding(cfg, params).to(x.dtype)


def forward(cfg: ModelConfig, params, batch, moe_impl=None):
    """Full forward → logits [B, S, Vp]."""
    x = final_hidden(cfg, params, batch, moe_impl)
    return x @ _unembedding(cfg, params).to(x.dtype)


def final_hidden(cfg: ModelConfig, params, batch, moe_impl=None):
    """Forward to the final (pre-unembedding) hidden states."""
    x = embed_inputs(cfg, params, batch)
    x, _ = _run_stack(cfg, params, x, None, moe_impl)
    return L.apply_norm(cfg.norm, x, params, "ln_f")


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


def loss_fn(cfg: ModelConfig, params, batch, moe_impl=None,
            ce_chunk: int = 512):
    """Next-token cross entropy, fp32, vocab-pad masked.

    The MoE defaults to :func:`train_moe_impl`. The unembedding and
    logsumexp run in sequence chunks, each under ``checkpoint`` while
    autograd records, so the full [B, S, V] logits never materialize.
    """
    x = final_hidden(cfg, params, batch, moe_impl or train_moe_impl(cfg))
    labels = batch["labels"]
    unembed = _unembedding(cfg, params)
    B, S, _ = x.shape
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
            nll_c, cnt_c = checkpoint(_ce_chunk, cfg, x_c, l_c, unembed,
                                      use_reentrant=False)
        else:
            nll_c, cnt_c = _ce_chunk(cfg, x_c, l_c, unembed)
        nll, cnt = nll + nll_c, cnt + cnt_c
    return nll / torch.clamp(cnt, min=1.0)


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, B: int, max_len: int,
               per_slot_len: bool = False, *, device="cuda"):
    """One ``{"k", "v", "len"}`` dict per layer; ``len`` is a scalar, or a
    [B] vector with ``per_slot_len`` (continuous batching)."""
    _require_moe(cfg)
    dev = resolve_device(device)
    shp = (B, max_len, cfg.n_kv_heads, cfg.hd)
    caches = []
    for _ in range(cfg.n_layers):
        zlen = torch.zeros((B,) if per_slot_len else (), dtype=torch.int32,
                           device=dev)
        caches.append({
            "k": torch.zeros(shp, dtype=cfg.compute_dtype, device=dev),
            "v": torch.zeros(shp, dtype=cfg.compute_dtype, device=dev),
            "len": zlen})
    return caches


def decode_step(cfg: ModelConfig, params, token, cache, moe_impl=None):
    """token: [B, 1] → (logits [B, 1, Vp], new_cache).

    The keys and values are written into ``cache`` in place (see
    ``layers.attention``); the returned cache holds the new lengths.
    """
    x = embed_inputs(cfg, params, {"tokens": token})
    x, new_cache = _run_stack(cfg, params, x, cache, moe_impl)
    x, unembed = _final(cfg, params, x)
    return x @ unembed, new_cache


def prefill(cfg: ModelConfig, params, batch, max_len: int, moe_impl=None):
    """Run the prompt through the stack, filling a new cache.

    Returns (last-token logits [B, Vp], cache).
    """
    tokens = batch["tokens"]
    B, _ = tokens.shape
    cache = init_cache(cfg, B, max_len, device=tokens.device)
    x = embed_inputs(cfg, params, batch)
    x, new_cache = _run_stack(cfg, params, x, cache, moe_impl)
    x, unembed = _final(cfg, params, x)
    return x[:, -1] @ unembed, new_cache
