"""Compressed cross-node messages — copy of ``int8_wire_bytes`` and a torch
counterpart of ``int8_roundtrip_np`` from ``repro.parallel.compression``.

Under ``ScheduleConfig(xnode_compress="int8")`` the cost model prices the
aggregated inter-node hop of two-level dispatch at ``int8_wire_bytes``, and
the executor's ``put_mem_signal`` tiles deliver ``int8_roundtrip`` of their
payload. The gradient-compression transforms are not ported yet.
"""

from __future__ import annotations

import torch

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
