"""Plain PyTorch versions of the port's kernels.

They follow the *kernels'* numerics, which are those of the Pallas kernels
(``repro/kernels/gmm.py``, ``repro/kernels/gmm_swiglu.py``,
``repro/kernels/gmm_swiglu_bwd.py``): products summed
in fp32, SwiGLU applied to the fp32 accumulators, one cast to x's dtype at the
end. ``repro.kernels.ref.gmm_swiglu_ref`` differs in bf16: its einsum rounds
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


def moe_ffn_ref(x, w_in, w_down):
    """Full expert FFN: x: [E, C, D] → [E, C, D]."""
    return gmm_ref(gmm_swiglu_ref(x, w_in), w_down)
