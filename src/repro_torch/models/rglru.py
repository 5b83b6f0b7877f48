"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427) —
counterpart of ``repro.models.rglru``.

Recurrence (per channel):
    r_t = σ(W_a x_t + b_a)            gate
    i_t = σ(W_x x_t + b_x)            input gate
    a_t = exp(-c · softplus(Λ) · r_t)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

A prompt or a training sequence runs the linear recurrence as a log-depth
scan over L (Hillis–Steele doubling on the pairs (a, b), ⌈log2 L⌉ steps of
whole-tensor ops), where the reference calls ``jax.lax.associative_scan``;
a one-token decode step is the single update. The gates read x in fp32,
and their weights and Λ are kept in fp32 for serving, as the reference
reads them.

Under an ambient ``parallel.tp.TensorParallel`` (training) a rank holds
its block of the w channels (``in_x``/``in_y`` columns, the conv, the gate
columns and biases, Λ, ``out`` rows): the conv and the scan run on its
channels, and the gates, which read every channel of the conv'd branch,
read it all-gathered over ``model``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.ctx import current_cache_blocks, current_tensor_parallel
from .layers import randn

C_RGLRU = 8.0


def init_rglru(gen: torch.Generator, d_model: int, lru_width: int,
               conv_width: int = 4, dtype=torch.float32):
    """Weights drawn in fp32 from ``gen`` on its device. The projections
    and the conv are kept in ``dtype``; the gates and Λ in fp32."""
    dev = gen.device
    w = lru_width

    def normal(shape, std):
        return randn(gen, shape) * std

    return {
        "in_x": normal((d_model, w), d_model ** -0.5).to(dtype),
        "in_y": normal((d_model, w), d_model ** -0.5).to(dtype),
        "conv_w": normal((conv_width, w), 0.1).to(dtype),
        "conv_b": torch.zeros(w, dtype=dtype, device=dev),
        "gate_a": normal((w, w), w ** -0.5),
        "gate_a_b": torch.zeros(w, device=dev),
        "gate_x": normal((w, w), w ** -0.5),
        "gate_x_b": torch.zeros(w, device=dev),
        # Λ so that a^c spans (0.9, 0.999), Griffin's stable range.
        "lam": torch.log(torch.expm1(
            -torch.log(torch.linspace(0.9, 0.999, w, device=dev))
            / C_RGLRU)),
        "out": normal((w, d_model), w ** -0.5).to(dtype),
    }


def _gates(x, p, whole=None):
    """(a, gated input) of the recurrence, fp32 [B, L, W]; ``whole``: the
    branch's every channel, which the gates read where ``x`` is a block of
    them (their weights the block's columns)."""
    xf = x.float()
    src = xf if whole is None else whole.float()
    r = torch.sigmoid(src @ p["gate_a"].float() + p["gate_a_b"])
    i = torch.sigmoid(src @ p["gate_x"].float() + p["gate_x_b"])
    log_a = -C_RGLRU * F.softplus(p["lam"])[None, None, :] * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * (i * xf)


def linear_scan(a, b):
    """Inclusive scan of h_t = a_t · h_{t-1} + b_t over dim 1 from h = 0:
    Hillis–Steele doubling, ⌈log2 L⌉ steps. Returns (Π a, h)."""
    L = a.shape[1]
    d = 1
    while d < L:
        # (a, b)[t] ← (a[t-d], b[t-d]) ∘ (a[t], b[t]) for t >= d.
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        b = torch.cat([b[:, :d], a[:, d:] * b_prev + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a_prev], dim=1)
        d *= 2
    return a, b


def _rglru_core(x, p, h0=None, whole=None):
    """x: [B, L, W] → (h [B, L, W] in x's dtype, h_last [B, W] fp32)."""
    a, gated = _gates(x, p, whole)
    if x.shape[1] == 1 and h0 is not None:
        h = a[:, 0] * h0 + gated[:, 0]
        return h[:, None].to(x.dtype), h
    if h0 is not None:
        gated = torch.cat([gated[:, :1] + (a[:, 0] * h0)[:, None],
                           gated[:, 1:]], dim=1)
    _, h = linear_scan(a, gated)
    return h.to(x.dtype), h[:, -1]


def rglru_block(p, x, state=None, conv_width: int = 4):
    """The Griffin recurrent block. x: [B, L, d] → (y, new_state);
    ``state`` = dict(conv [B, W-1, w], h [B, w] fp32) for serving.

    On a process mesh (an ambient ``parallel.tp.CacheBlocks``) ``state``
    holds the rank's ``cache_spec`` blocks over the channels: under tensor
    parallelism the rank's own, otherwise gathered whole and the new
    state's blocks kept."""
    from .ssm import _causal_conv
    tp = current_tensor_parallel()
    cb = current_cache_blocks() if state is not None else None
    if state is not None and cb is None:
        tp = None
    if tp is not None:
        x = tp.enter(x)
    dt = x.dtype
    branch = x @ p["in_x"].to(dt)
    gate = F.gelu(x @ p["in_y"].to(dt), approximate="tanh")
    conv_state = state["conv"] if state is not None else None
    h0 = state["h"] if state is not None else None
    gathered = cb is not None and tp is None
    if gathered:
        w = p["lam"].shape[0]
        conv_state, h0 = cb.whole(conv_state, -1, w), cb.whole(h0, 1, w)
    branch, conv_tail = _causal_conv(branch, p["conv_w"].to(dt),
                                     p["conv_b"].to(dt), conv_state)
    h, h_last = _rglru_core(branch, p, h0,
                            None if tp is None else tp.gather_cols(branch))
    y = (h * gate) @ p["out"].to(dt)
    new_state = None
    if state is not None:
        new_state = ({"conv": cb.block(conv_tail, -1),
                      "h": cb.block(h_last, 1)} if gathered
                     else {"conv": conv_tail, "h": h_last})
    return (y if tp is None else tp.leave(y)), new_state


def rglru_reference(x, p, h0=None):
    """The plain recurrence, one step a token (the tests' oracle)."""
    a, gated = _gates(x, p)
    h = torch.zeros_like(a[:, 0]) if h0 is None else h0
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + gated[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)
