"""Expert-parallel helpers — counterpart of ``repro.parallel.ep``.

Only ``ring_chunk_caps`` is ported so far: the decode-trace replay
(``launch/replay.py``) counts the distinct cap tuples a bucket policy gives
the RATR ring, i.e. how often a plan-sized EP step would be rebuilt. The
EP paths themselves (``EPConfig``, ``make_moe_ep``, the AllToAll baseline
and the ring) need several cards and come with the EP slice.
"""

from __future__ import annotations

import numpy as np


def ring_chunk_caps(plan, ep: int, topology=None, bucket=None,
                    inter_bucket=None) -> tuple:
    """Per-ring-step row caps from a :class:`RoutingPlan`.

    ``caps[k]`` is the largest per-(dst, expert) row count any source rank
    moves at ring distance ``k`` (source ``s`` → destination ``(s + k) %
    ep``); a step whose cap is 0 carries only padding for every rank. All
    ranks move one shape per step, so the straggler source sets the cap.

    With a :class:`repro_torch.core.hardware.Topology`, ring step ``k`` is
    an inter-node step when any source's hop at distance ``k`` crosses a
    node boundary: intra-node steps quantize their caps with ``bucket``,
    inter-node steps with ``inter_bucket`` (anything
    ``BucketSpec.from_any`` takes; ``None`` leaves that class exact).
    Quantization only rounds caps up, and zero caps stay zero.
    """
    if plan.ep != ep:
        raise ValueError(f"plan ep={plan.ep} != mesh ep={ep}")
    c = np.asarray(plan.counts, dtype=np.int64)       # [src, dst, e_loc]
    caps = []
    for k in range(ep):
        dst = (np.arange(ep) + k) % ep
        caps.append(int(c[np.arange(ep), dst].max()))
    if bucket is None and inter_bucket is None:
        return tuple(caps)
    if inter_bucket is not None and topology is None:
        raise ValueError(
            "inter_bucket needs a topology to tell inter-node ring steps "
            "from intra-node ones")
    from ..core.buckets import BucketSpec

    def quantize(cap: int, b) -> int:
        if b is None or cap == 0:
            return cap
        return int(BucketSpec.from_any(b).quantize(np.array([cap]))[0])

    out = []
    for k, cap in enumerate(caps):
        inter = topology is not None and any(
            not topology.same_node(s, (s + k) % ep) for s in range(ep))
        b = inter_bucket if (inter and inter_bucket is not None) else bucket
        out.append(quantize(cap, b))
    return tuple(out)
