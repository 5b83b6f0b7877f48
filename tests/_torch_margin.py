"""The margin rule of the port's tests: a greedy token or an expert choice
is compared exactly only where the port's fp32 logits decide it by at least
MARGIN of their range. Below that, two runs whose sums differ only in
order may pick either side of a near-tie, so only values are compared,
within a tolerance.

``watch_batcher`` records each decision's logits of either package's
``ContinuousBatcher`` and can feed it given tokens (teacher forcing), so
that two batchers see the same inputs whatever their near-ties picked;
``check_decisions`` then holds their logits together and compares the
tokens of the decided decisions exactly.
"""

import contextlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

MARGIN = 1e-3          # least gap between ranked choices, of their range


def ranked_gaps(logits, k=1):
    """Per row of ``logits`` [..., n]: the least gap between consecutive
    ones of its k + 1 largest values (what picks and orders its top k), over
    the row's range."""
    logits = torch.as_tensor(logits).float()
    top = torch.topk(logits, k + 1, dim=-1).values
    span = logits.amax(-1) - logits.amin(-1)
    return (top[..., :-1] - top[..., 1:]).amin(-1) / span


def decided(logits, k=1):
    """Rows of ``logits`` whose top k is picked and ordered by at least
    MARGIN of their range."""
    return ranked_gaps(logits, k) >= MARGIN


def assert_decided(rows):
    """Asserts, before an exact comparison of greedy tokens, that every row
    of logits in ``rows`` decides its top-1 by at least MARGIN."""
    m = min(float(ranked_gaps(r)) for r in rows)
    assert m >= MARGIN, (
        f"a greedy decision's top-1/top-2 gap is {m:.2e} of the logits' "
        f"range, below {MARGIN}: tokens cannot be compared exactly")


def _rows(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu()
    return np.asarray(x, np.float64)


@contextlib.contextmanager
def watch_batcher(b, forced=None):
    """Yields {request id: [logits of each of its greedy decisions, fp64]}
    as batcher ``b`` (the JAX package's or the port's) serves. With
    ``forced`` ({request id: tokens}) ``b`` takes those tokens in place of
    its own argmax. An idle slot's row is always made to pick token 0, so
    that a decode step's batch (which the MoE's capacity couples) is the
    same in every watched run."""
    logs, cur, n = {}, {}, b.n_slots
    jax_batcher = hasattr(b, "_decode")       # jitted closures on b
    owner = b if jax_batcher else sys.modules[type(b).__module__].M
    names = ("_prefill1", "_decode") if jax_batcher else ("prefill",
                                                           "decode_step")
    fns = [getattr(owner, a) for a in names]
    admit = b.admit

    def pick(lg, idx, tok):
        if jax_batcher:
            return lg.at[idx].set(0.0).at[idx + (tok,)].set(1.0)
        lg = lg.clone()
        lg[idx] = 0.0
        lg[idx + (tok,)] = 1.0
        return lg

    def record(rid, row):
        logs.setdefault(rid, []).append(_rows(row))
        if forced is not None:
            return forced[rid][len(logs[rid]) - 1]
        return None

    def admit_(rid, *a, **k):
        cur["rid"] = rid
        return admit(rid, *a, **k)

    def prefill(*a, **k):
        lg, cache = fns[0](*a, **k)
        tok = record(cur["rid"], lg[0])
        return (lg if tok is None else pick(lg, (0,), tok)), cache

    def decode_step(*a, **k):
        lg, cache = fns[1](*a, **k)
        for s in range(n):
            tok = (record(b.req_id[s], lg[s, -1]) if b.active[s] else 0)
            if tok is not None:
                lg = pick(lg, (s, -1), tok)
        return lg, cache

    b.admit = admit_
    for a, f in zip(names, (prefill, decode_step)):
        setattr(owner, a, f)
    try:
        yield logs
    finally:
        del b.admit
        for a, f in zip(names, fns):
            setattr(owner, a, f)


def check_decisions(ref, other, tokens, tol):
    """Holds ``other``'s decision logits to ``ref``'s (``watch_batcher``
    logs of two runs fed the same ``tokens``, ``ref`` the port's fp32 run)
    within ``tol`` (relative and absolute), and, where ``ref`` decides by
    at least MARGIN, ``other``'s greedy token to ``tokens`` exactly.
    Returns, a request, the count of its tokens compared exactly."""
    exact = {}
    for rid, toks in tokens.items():
        assert len(ref[rid]) == len(other[rid]) == len(toks), rid
        exact[rid] = 0
        for i, (r, o, t) in enumerate(zip(ref[rid], other[rid], toks)):
            np.testing.assert_allclose(
                o, r, rtol=tol, atol=tol,
                err_msg=f"request {rid}, decision {i}")
            gap = float(ranked_gaps(r))
            if gap >= MARGIN:
                assert int(np.argmax(o)) == t, (
                    f"request {rid}, decision {i}: the port decides it by "
                    f"{gap:.2e} of the logits' range (at least {MARGIN}), "
                    f"yet this run picks {int(np.argmax(o))}, not {t}")
                exact[rid] += 1
    return exact
