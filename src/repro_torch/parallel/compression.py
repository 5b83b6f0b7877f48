"""Compressed cross-node messages and gradients — counterpart of
``repro.parallel.compression``.

Under ``ScheduleConfig(xnode_compress="int8")`` the cost model prices the
aggregated inter-node hop of two-level dispatch at ``int8_wire_bytes``, and
the executor's ``put_mem_signal`` tiles deliver ``int8_roundtrip`` of their
payload.

The gradient transforms plug into ``optim.adamw.apply_updates``'s
``grad_transform`` hook, on the port's param trees:

* ``bf16_compress`` — each grad rounded through bf16 (halves the bytes of
  a cross-pod reduce);
* ``int8_ef_compress`` — per-tensor symmetric int8 with error feedback: the
  quantization residual is carried in a state tree (``int8_ef_init``) and
  added back next step, so the error does not accumulate.
"""

from __future__ import annotations

import torch

from ..optim.adamw import tree_map

# Wire overhead of one compressed message: the fp32 scale, padded to a row
# multiple on real transports — 8 bytes models scale + header.
INT8_SCALE_BYTES = 8


def int8_wire_bytes(nbytes: int, dtype_bytes: int = 2) -> int:
    """Bytes on the wire for an int8-compressed message of ``nbytes``
    full-precision payload (one int8 per element + per-message scale)."""
    return nbytes // max(1, dtype_bytes) + INT8_SCALE_BYTES


def int8_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """Symmetric per-message int8 quantize→dequantize, on x's device.

    What the inter-node hop delivers under ``xnode_compress="int8"``: a
    per-message max-abs scale, round to nearest even, clip to ±127. The
    reference takes the scale in float64 and applies it in float32; so does
    this, with no copy to the host.
    """
    x32 = x.float()
    amax = x32.abs().amax().double() if x32.numel() else \
        torch.zeros((), dtype=torch.float64, device=x.device)
    scale = (torch.clamp(amax, min=1e-12) / 127.0).float()
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return (q.float() * scale).to(x.dtype)


def bf16_compress(grads):
    """Round-trip each grad through bf16."""
    return tree_map(lambda g: g.to(torch.bfloat16).to(g.dtype), grads)


def int8_ef_init(params):
    """Zero fp32 error state of ``params``' tree."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def int8_ef_compress(grads, error_state):
    """Symmetric per-tensor int8 with error feedback.

    Returns (decompressed grads, new error state): each grad plus its
    carried error is quantized with a max-abs scale (round to nearest even,
    clipped to ±127) and dequantized; what that lost is the new error.
    """
    def q_deq(g, e):
        g32 = g.float() + e
        scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        return (q.float() * scale).to(g.dtype)

    deq = tree_map(q_deq, grads, error_state)
    err = tree_map(lambda g, e, d: g.float() + e - d.float(), grads,
                   error_state, deq)
    return deq, err
