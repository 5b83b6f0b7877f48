"""Plain PyTorch versions of the port's kernels.

They follow the *kernels'* numerics, which are those of the Pallas kernels
(``repro/kernels/gmm.py``, ``repro/kernels/gmm_swiglu.py``,
``repro/kernels/gmm_swiglu_bwd.py``, ``repro/kernels/swiglu_add.py``):
products summed in fp32, SwiGLU applied in fp32, one cast to x's dtype at
the end (and, in serial SwiGLU + Add, one more between the two steps). ``repro.kernels.ref.gmm_swiglu_ref`` differs in bf16: its einsum rounds
the gate/up product ``h`` to bf16 before the SwiGLU. The port follows the
kernel, so in fp32 the two agree and in bf16 they differ by that one rounding.

On a CPU tensor the kernel wrappers run these; on the card they are only the
yardstick a kernel is checked against.
"""

from __future__ import annotations

import torch


def gmm_ref(x, w):
    """Grouped GEMM. x: [E, C, K]; w: [E, K, N] → [E, C, N] in x's dtype."""
    return torch.bmm(x.float(), w.float()).to(x.dtype)


def gmm_swiglu_ref(x, w_in):
    """GMM1 + SwiGLU. x: [E, C, K]; w_in: [E, K, 2F] (gate ‖ up) → [E, C, F].
    """
    f = w_in.shape[-1] // 2
    xf = x.float()
    g = torch.bmm(xf, w_in[..., :f].float())
    u = torch.bmm(xf, w_in[..., f:].float())
    return (g * torch.sigmoid(g) * u).to(x.dtype)


def gmm_swiglu_bwd_ref(x, w4, dout):
    """Backward of GMM1 + SwiGLU, the formulas of the Pallas bodies.

    x: [E, C, K]; w4: [E, K, 2, F] (gate, up); dout: [E, C, F] →
    (dx fp32 [E, C, K], dw4 fp32 [E, K, 2, F]). The gate and up products
    are recomputed in fp32; then dg = dout ⊙ u ⊙ silu′(g), du = dout ⊙
    silu(g), dx = dg·Wgᵀ + du·Wuᵀ, dWg = xᵀ·dg and dWu = xᵀ·du, all fp32.
    """
    xf, do = x.float(), dout.float()
    wg, wu = w4[:, :, 0].float(), w4[:, :, 1].float()
    g, u = torch.bmm(xf, wg), torch.bmm(xf, wu)
    sig = torch.sigmoid(g)
    silu = g * sig
    dsilu = sig * (1.0 + g * (1.0 - sig))
    dg, du = do * u * dsilu, do * silu
    dx = (torch.bmm(dg, wg.transpose(1, 2))
          + torch.bmm(du, wu.transpose(1, 2)))
    xt = xf.transpose(1, 2)
    dw4 = torch.stack([torch.bmm(xt, dg), torch.bmm(xt, du)], dim=2)
    return dx, dw4


def swiglu_ref(h):
    """h: [M, 2F] → silu(h[:, :F]) · h[:, F:] in fp32, stored in h's dtype."""
    f = h.shape[-1] // 2
    a = h[..., :f].float()
    return (a * torch.sigmoid(a) * h[..., f:].float()).to(h.dtype)


def swiglu_add_ref(h, y):
    """Interleaved SwiGLU + Add: [M, 2F], [M, F] → [M, F], all in fp32 and
    rounded once to h's dtype (``_swiglu_add_kernel``)."""
    f = h.shape[-1] // 2
    a = h[..., :f].float()
    g = a * torch.sigmoid(a) * h[..., f:].float()
    return (g + y.float()).to(h.dtype)


def swiglu_add_serial_ref(h, y):
    """Serial SwiGLU then Add: g is rounded to h's dtype between the two
    steps, as the two Pallas calls store it (``_swiglu_kernel``, then
    ``_add_kernel``)."""
    return (swiglu_ref(h).float() + y.float()).to(h.dtype)


def moe_ffn_ref(x, w_in, w_down):
    """Full expert FFN: x: [E, C, D] → [E, C, D]."""
    return gmm_ref(gmm_swiglu_ref(x, w_in), w_down)
