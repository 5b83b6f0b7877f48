"""Plain PyTorch versions of the port's kernels.

They follow the *kernels'* numerics, which are those of the Pallas kernels
(``repro/kernels/gmm.py``, ``repro/kernels/gmm_swiglu.py``): products summed
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


def moe_ffn_ref(x, w_in, w_down):
    """Full expert FFN: x: [E, C, D] → [E, C, D]."""
    return gmm_ref(gmm_swiglu_ref(x, w_in), w_down)
