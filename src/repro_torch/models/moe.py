"""Mixture-of-Experts FFN: router + expert execution — counterpart of
``repro.models.moe``.

* ``moe_dense_ref`` — one-hot einsum over all experts; the oracle.
* ``moe_grouped``  — capacity-based dispatch/combine with sorted token
  buffers feeding a grouped GEMM; ``gmm_fn=kernels.ops.moe_expert_ffn`` runs
  it through the Hopper kernels (the model's default).

Routing uses fixed expert capacity:
``capacity = ceil(tokens · top_k / E · capacity_factor)``; overflow tokens
are dropped (the dense ref applies the same mask).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from .layers import glu_act


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN width (branch width)
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # Experts padded up so E % ep == 0 (router never selects padding).
    n_padding_experts: int = 0

    @property
    def e_total(self) -> int:
        return self.n_experts + self.n_padding_experts


def init_moe(gen: torch.Generator, d_model: int, mc: MoEConfig,
             dtype=torch.float32):
    """Router in fp32 (it always runs in fp32); expert weights in ``dtype``."""
    E = mc.e_total
    std = d_model ** -0.5

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=gen.device) * scale

    return {
        "router": normal((d_model, E), std),
        "w_in": normal((E, d_model, 2 * mc.d_expert), std).to(dtype),
        "w_down": normal((E, mc.d_expert, d_model),
                         mc.d_expert ** -0.5).to(dtype),
    }


def router_topk(p_router, x, mc: MoEConfig):
    """Top-k routing with renormalized softmax probs.

    x: [T, d] → (probs [T, k], idx [T, k]).  Padding experts are masked out.
    The logits are fp32 whatever the router's dtype, as JAX's einsum promotes
    a bf16 router (training casts every float leaf to bf16).
    """
    logits = x.float() @ p_router.float()
    if mc.n_padding_experts:
        pad_mask = torch.arange(mc.e_total, device=x.device) >= mc.n_experts
        logits = torch.where(pad_mask[None, :], -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, mc.top_k, dim=-1)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    return top_p, top_i


def capacity(tokens: int, mc: MoEConfig, ep: int = 1) -> int:
    """Per-expert capacity, rounded up to a multiple of ``ep``."""
    c = int(math.ceil(tokens * mc.top_k / mc.e_total * mc.capacity_factor))
    return max(ep, ((c + ep - 1) // ep) * ep)


def expert_ffn(w_in, w_down, x, act: str = "swiglu"):
    """x: [E, C, d] per-expert batches → [E, C, d]."""
    h = torch.bmm(x, w_in.to(x.dtype))
    h = glu_act(h, act)
    return torch.bmm(h, w_down.to(x.dtype))


def make_dispatch(top_p, top_i, T: int, E: int, C: int):
    """Position-in-expert assignment under fixed capacity.

    Returns (combine_w [T,k], expert [T,k], slot [T,k] in [0, C) or C for
    dropped).
    """
    k = top_i.shape[1]
    flat_e = top_i.reshape(-1)                                  # [T*k]
    # position of each (token, choice) within its expert, in token order
    onehot = F.one_hot(flat_e, E)                               # [T*k, E]
    pos = torch.cumsum(onehot, dim=0) - 1                       # running idx
    slot = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    keep = slot < C
    return (top_p * keep.reshape(T, k)), flat_e.reshape(T, k), \
        torch.where(keep, slot, C).reshape(T, k)


def _routed(params, xt, mc: MoEConfig, C: int):
    top_p, top_i = router_topk(params["router"], xt, mc)
    return make_dispatch(top_p, top_i, xt.shape[0], mc.e_total, C)


def moe_dense_ref(params, x, mc: MoEConfig, act: str = "swiglu",
                  cap: Optional[int] = None):
    """One-hot dense-einsum oracle (same capacity-drop mask, no scatter)."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    E = mc.e_total
    C = cap or capacity(T, mc)
    top_p, top_i, slot = _routed(params, xt, mc, C)
    # dispatch_mask[t, k, e, c]: token t's k-th choice occupies (e, c);
    # a dropped choice (slot C) occupies nothing.
    e_oh = F.one_hot(top_i, E).to(xt.dtype)                    # [T,k,E]
    c_oh = F.one_hot(slot, C + 1)[..., :C].to(xt.dtype)        # [T,k,C]
    disp_mask = torch.einsum("tke,tkc->tec", e_oh, c_oh)
    disp = torch.einsum("tec,td->ecd", disp_mask, xt)
    out_e = expert_ffn(params["w_in"], params["w_down"], disp, act)
    comb = torch.einsum("tke,tkc,tk->tec", e_oh, c_oh, top_p.to(xt.dtype))
    y = torch.einsum("tec,ecd->td", comb, out_e)
    return y.reshape(B, S, d)


def moe_grouped(params, x, mc: MoEConfig, act: str = "swiglu",
                cap: Optional[int] = None, gmm_fn=None):
    """Sorted/capacity dispatch → grouped FFN → weighted combine.

    ``gmm_fn(x_disp [E, C, d], w_in, w_down, act)`` overrides the expert FFN
    (``kernels.ops.moe_expert_ffn`` runs the Hopper kernels); defaults to the
    einsum path.
    """
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    E = mc.e_total
    C = cap or capacity(T, mc)
    top_p, top_i, slot = _routed(params, xt, mc, C)

    # Dispatch: scatter tokens into [E, C, d] expert buffers; row C takes
    # every dropped choice and is cut off.
    disp = torch.zeros((E, C + 1, d), dtype=x.dtype, device=x.device)
    tok_idx = torch.arange(T, device=x.device)[:, None].expand_as(top_i)
    disp.index_put_((top_i.reshape(-1), slot.reshape(-1)),
                    xt[tok_idx.reshape(-1)], accumulate=True)
    disp = disp[:, :C].contiguous()

    if gmm_fn is not None:
        out_e = gmm_fn(disp, params["w_in"], params["w_down"], act)
    else:
        out_e = expert_ffn(params["w_in"], params["w_down"], disp, act)

    # Combine: gather back with routing weights, summed in x's dtype in k
    # order (a dropped choice reads the zero row C).
    out_e = torch.cat([out_e, torch.zeros_like(out_e[:, :1])], dim=1)
    y = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for j in range(mc.top_k):
        y = y + (out_e[top_i[:, j], slot[:, j]]
                 * top_p[:, j][:, None].to(x.dtype))
    return y.reshape(B, S, d)
