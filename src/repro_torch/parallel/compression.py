"""Wire-size helper for compressed cross-node messages — copy of
``int8_wire_bytes`` from ``repro.parallel.compression``.

Under ``ScheduleConfig(xnode_compress="int8")`` the cost model prices the
aggregated inter-node hop of two-level dispatch at this size. The
compression transforms themselves are not ported yet.
"""

from __future__ import annotations

# Wire overhead of one compressed message: the fp32 scale, padded to a row
# multiple on real transports — 8 bytes models scale + header.
INT8_SCALE_BYTES = 8


def int8_wire_bytes(nbytes: int, dtype_bytes: int = 2) -> int:
    """Bytes on the wire for an int8-compressed message of ``nbytes``
    full-precision payload (one int8 per element + per-message scale)."""
    return nbytes // max(1, dtype_bytes) + INT8_SCALE_BYTES
