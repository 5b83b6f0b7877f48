"""Mamba2 — State Space Duality (SSD), chunked scan + decode step —
counterpart of ``repro.models.ssm``.

The chunked SSD algorithm of arXiv:2405.21060 §6: within a chunk the output
is a masked, decay-weighted attention-like product; chunk boundary states
are carried by a linear recurrence, here a Python loop over the chunks
(16 at 4,096 tokens with chunk 256). Every product is a plain
``torch.matmul``/``einsum``: the reference computes them in plain JAX, with
no Pallas kernel.

Decode keeps the recurrent state S ∈ [B, H, N, P]:
    S_t = a_t · S_t-1 + dt·B_tᵀ ⊗ x_t ;   y_t = C_t · S_t + D ⊙ x_t.

As in the reference, a prompt's length L must be a multiple of
``min(chunk, L)``: a longer prompt that is not a multiple of the chunk
raises ``ValueError`` (the reference asserts; nothing is padded).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .layers import randn


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128           # N
    head_dim: int = 64           # P
    expand: int = 2              # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 128             # SSD chunk length Q

    def n_heads(self, d_model: int) -> int:
        return self.expand * d_model // self.head_dim


def init_ssm(gen: torch.Generator, d_model: int, sc: SSMConfig,
             dtype=torch.float32):
    """Weights drawn in fp32 from ``gen`` on its device, kept in ``dtype``,
    but for ``A_log`` and ``dt_bias``, which the reference reads in fp32."""
    H = sc.n_heads(d_model)
    d_in = sc.expand * d_model
    N = sc.d_state
    dev = gen.device

    def normal(shape, std):
        return (randn(gen, shape) * std).to(dtype)

    zxbcdt = d_in + d_in + N + N + H      # in_proj: [z, x, B, C, dt] fused
    return {
        "in_proj": normal((d_model, zxbcdt), d_model ** -0.5),
        "conv_w": normal((sc.conv_width, d_in + 2 * N), 0.1),
        "conv_b": torch.zeros(d_in + 2 * N, dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)),
        "D": torch.ones(H, dtype=dtype, device=dev),
        "dt_bias": torch.zeros(H, device=dev),
        "out_proj": normal((d_in, d_model), d_in ** -0.5),
        "norm_w": torch.zeros(d_in, dtype=dtype, device=dev),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv1d. x: [B, L, C]; w: [W, C]. Returns
    (y, tail), tail the last W - 1 inputs (the next call's ``state``)."""
    W = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state
    xp = torch.cat([pad, x], dim=1)
    L = x.shape[1]
    y = xp[:, 0:L] * w[0][None, None, :]
    for i in range(1, W):
        y = y + xp[:, i:i + L] * w[i][None, None, :]
    return y + b[None, None, :], xp[:, -(W - 1):]


def _check_chunk(L: int, chunk: int) -> None:
    if L % chunk:
        raise ValueError(f"sequence length {L} must be a multiple of the "
                         f"SSD chunk {chunk}")


def _ssd_chunked(x, dt, A, B, C, D, chunk: int):
    """Chunked SSD scan.

    x: [b, L, H, P]; dt: [b, L, H]; A: [H] (negative rates); B, C: [b, L, N]
    (one group); D: [H]. Returns (y [b, L, H, P], final state
    [b, H, N, P]).
    """
    b, L, H, P = x.shape
    N = B.shape[-1]
    Q = chunk
    _check_chunk(L, Q)
    nc = L // Q

    la = (dt * A[None, None, :]).reshape(b, nc, Q, H)   # log decay per step
    xc = x.reshape(b, nc, Q, H, P)
    dtc = dt.reshape(b, nc, Q, H)
    Bc = B.reshape(b, nc, Q, N)
    Cc = C.reshape(b, nc, Q, N)

    cs = torch.cumsum(la, dim=2)                        # [b,nc,Q,H]
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]   # [b,nc,Q(i),Q(j),H]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))[None, None, :, :, None]
    # Mask before exp: the non-causal entries are positive and would
    # overflow, poisoning gradients through the where.
    decay = torch.exp(torch.where(causal, seg, -torch.inf))

    # Intra-chunk (the attention-like quadratic term).
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)    # [b,nc,Q,Q]
    M = scores[..., None] * decay                       # [b,nc,Q,Q,H]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M * dtc[:, :, None],
                           xc)

    # Chunk states: S_c = Σ_j exp(cs_end - cs_j) dt_j B_j x_jᵀ.
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)     # [b,nc,Q,H]
    S_c = torch.einsum("bcjn,bcjhp->bchnp", Bc,
                       (dtc * decay_to_end)[..., None] * xc)

    # Inter-chunk recurrence over the chunk states.
    a_chunk = torch.exp(cs[:, :, -1, :])                # [b,nc,H]
    S = torch.zeros((b, H, N, P), dtype=x.dtype, device=x.device)
    S_prevs = []
    for c in range(nc):
        S_prevs.append(S)
        S = S * a_chunk[:, c, :, None, None] + S_c[:, c]
    S_prevs = torch.stack(S_prevs, dim=1)               # [b,nc,H,N,P]

    decay_from_start = torch.exp(cs)                    # [b,nc,Q,H]
    y_inter = (torch.einsum("bcin,bchnp->bcihp", Cc, S_prevs)
               * decay_from_start[..., None])

    y = (y_intra + y_inter).reshape(b, L, H, P)
    return y + x * D[None, None, :, None], S


def ssm_forward(p, x, sc: SSMConfig, state=None):
    """The Mamba2 mixer. x: [B, L, d_model] → (y, new_state).

    ``state`` = dict(conv [B, W-1, d_conv], ssm [B, H, N, P]) for serving:
    a prompt (L > 1) fills it, a one-token step updates it. Without a state
    no state is returned.
    """
    Bsz, L, d_model = x.shape
    H = sc.n_heads(d_model)
    P, N = sc.head_dim, sc.d_state
    d_in = sc.expand * d_model
    dt_f = x.dtype

    zxbcdt = x @ p["in_proj"].to(dt_f)
    z, xs, B_, C_, dt = torch.split(zxbcdt, [d_in, d_in, N, N, H], dim=-1)

    conv_in = torch.cat([xs, B_, C_], dim=-1)
    conv_state = state["conv"] if state is not None else None
    conv_out, conv_tail = _causal_conv(conv_in, p["conv_w"].to(dt_f),
                                       p["conv_b"].to(dt_f), conv_state)
    conv_out = F.silu(conv_out)
    xs, B_, C_ = torch.split(conv_out, [d_in, N, N], dim=-1)

    xh = xs.reshape(Bsz, L, H, P)
    dt = F.softplus(dt.float() + p["dt_bias"][None, None, :])  # [B,L,H]
    A = -torch.exp(p["A_log"])                                 # [H] < 0

    new_state = None
    if state is not None and L == 1:
        # The recurrent decode step.
        a = torch.exp(dt[:, 0] * A[None, :])                   # [B,H]
        dBx = torch.einsum("bh,bn,bhp->bhnp", dt[:, 0].to(dt_f), B_[:, 0],
                           xh[:, 0])
        S = state["ssm"] * a[..., None, None].to(dt_f) + dBx
        y = torch.einsum("bn,bhnp->bhp", C_[:, 0], S)
        y = y + xh[:, 0] * p["D"].to(dt_f)[None, :, None]
        y = y[:, None]                                         # [B,1,H,P]
        new_state = {"conv": conv_tail, "ssm": S}
    else:
        y, S_final = _ssd_chunked(xh, dt.to(dt_f), A.to(dt_f), B_, C_,
                                  p["D"].to(dt_f), min(sc.chunk, L))
        if state is not None:
            # Prefill: hand the final recurrent and conv state to decode.
            new_state = {"conv": conv_tail, "ssm": S_final}

    y = y.reshape(Bsz, L, d_in)
    # Gated RMSNorm (Mamba2's norm before the out-projection).
    y = y * F.silu(z)
    var = torch.mean(torch.square(y.float()), dim=-1, keepdim=True)
    y = (y.float() * torch.rsqrt(var + 1e-6)).to(dt_f)
    y = y * (1.0 + p["norm_w"].to(dt_f))[None, None, :]
    return y @ p["out_proj"].to(dt_f), new_state


def ssd_reference(x, dt, A, B, C, D):
    """The plain recurrence, one step a token (the tests' oracle)."""
    b, L, H, P = x.shape
    N = B.shape[-1]
    S = torch.zeros((b, H, N, P), dtype=x.dtype, device=x.device)
    ys = []
    for t in range(L):
        a = torch.exp(dt[:, t] * A)                            # [b,H]
        S = S * a[..., None, None] + torch.einsum(
            "bh,bn,bhp->bhnp", dt[:, t], B[:, t], x[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", C[:, t], S))
    y = torch.stack(ys, dim=1)
    return y + x * D[None, None, :, None]
