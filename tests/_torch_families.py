"""What the model-family tests share (``tests/test_torch_families.py`` for
the dense and moe-layernorm archs, ``tests/test_torch_ssm.py`` for mamba2
and recurrentgemma): each arch's smoke-config inputs, made once in numpy
and fed to both packages through ``convert``; the reference's and the
port's runs on them; and the checks of the forward, the loss and every
grad leaf, and prefill and teacher-forced decode.

Two comparisons, each with tolerances fixed here:

* fp32, the port against the JAX package: every value within 1e-5 of the
  reference's largest value of the compared tensor, or 1e-4 for mamba2 and
  recurrentgemma, whose chunked SSD and log-depth scan sum in another order
  than the reference's.
* bf16, the port against its own fp32 run on the same inputs (never against
  JAX's bf16, whose rounding takes other paths on other CPUs): logits within
  ``BF16_LOGITS`` of the fp32 run's largest logit, the loss within
  ``BF16_LOSS`` of it, each grad leaf within ``BF16_GRAD`` of the fp32
  leaf by norm. bf16 keeps 8 significant bits (unit roundoff u = 2^-9); the
  smoke configs' 2 to 5 layers round each activation a few times, so the
  logits' error is some u per rounding times the layers: 5e-2 is 25 u. A
  loss is a mean over 48 tokens whose rounding errors mostly cancel: 5e-3.
  A grad leaf sums a product of two bf16 chains: 8e-2, 40 u.

A MoE arch's bf16 run can route a token to other experts than its fp32 run
(a near-tie of the router's logits, which both packages compute in fp32
from bf16 hidden states). A different expert is a discrete change, not a
rounding one, so the bf16 tests first compare the two runs' expert
choices: they compare only the positions before a sequence's first
differing choice (attention is causal, and the bf16 runs of a MoE take
capacity factor 4.0, so no token is dropped and no token's choices move
another's), and grads only when every choice agrees; otherwise the fp32
comparison with JAX stands alone.

Every cached array is read-only (``frozen``): a test that writes into a
shared input raises instead of changing the inputs of the tests after it.
"""

import contextlib
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.configs import get_smoke_config as tget_smoke  # noqa: E402
from repro_torch.convert import (params_from_numpy,  # noqa: E402
                                 train_params_from_numpy)
from repro_torch.launch import steps as St  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False

NEW = ["llama3_2-3b", "qwen2-1_5b", "olmo-1b", "gemma-2b", "dbrx-132b",
       "mamba2-1_3b", "recurrentgemma-2b"]
SCANNED = ("mamba2-1_3b", "recurrentgemma-2b")
B, S, PRE = 2, 24, 16
BF16_LOGITS, BF16_LOSS, BF16_GRAD = 5e-2, 5e-3, 8e-2


def fp32_tol(arch):
    """fp32 tolerance against JAX."""
    return 1e-4 if arch in SCANNED else 1e-5


def near(got, want, tol, what=""):
    """max |got - want| <= tol · max |want|."""
    got = np.asarray(got.detach().float().numpy() if isinstance(
        got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    scale = float(np.max(np.abs(want)))
    assert err <= tol * scale, (what, err, tol, scale)


def frozen(tree):
    """``tree`` with every numpy array made read-only."""
    for a in jax.tree.leaves(tree):
        if isinstance(a, np.ndarray):
            a.setflags(write=False)
    return tree


def cfgs(arch, dtype, roomy=False):
    """Both packages' smoke configs at ``dtype``; ``roomy`` raises a MoE's
    capacity factor to 4.0 (4 experts, top-2: nothing is dropped)."""
    out = []
    for get in (jget_smoke, tget_smoke):
        cfg = dataclasses.replace(get(arch), dtype=dtype)
        if cfg.moe is not None and roomy:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=4.0))
        out.append(cfg)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def inputs(arch):
    """JAX's init (seed 0) with every norm leaf redrawn around its neutral
    value (rmsnorm w ~ 0, layernorm scale ~ 1, bias ~ 0): the reference
    starts layernorm scales at 0, which zeroes dbrx's whole stack. Tokens
    and labels from a numpy generator."""
    jcfg = jget_smoke(arch)
    rng = np.random.default_rng(7)

    def norm_leaf(path, a):
        name = str(getattr(path[-1], "key", ""))
        if not name.startswith("ln"):
            return np.array(a)
        base = 1.0 if jcfg.norm == "layernorm" and not name.endswith("_b") \
            else 0.0
        return (base + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    np_params = jax.tree_util.tree_map_with_path(
        norm_leaf, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    return frozen((np_params, tokens, labels))


def batch_of(arch):
    _, tokens, labels = inputs(arch)
    return {"tokens": torch.tensor(tokens, dtype=torch.long),
            "labels": torch.tensor(labels, dtype=torch.long)}


@functools.lru_cache(maxsize=None)
def jax_run(arch):
    """The reference in fp32: forward, loss and grads, and prefill of PRE
    tokens then teacher-forced decode to S, in numpy. Each of the two
    halves is one jitted function."""
    jcfg, _ = cfgs(arch, "float32")
    np_params, tokens, labels = inputs(arch)
    params = jax.tree.map(jnp.asarray, np_params)
    tokens = jnp.asarray(tokens)

    @jax.jit
    def train_half(params, tokens, labels):
        logits = JM.forward(jcfg, params, {"tokens": tokens})
        batch = {"tokens": tokens, "labels": labels}
        loss, grads = jax.value_and_grad(
            lambda p: JM.loss_fn(jcfg, p, batch))(
                jadamw.cast_params(params, jcfg.compute_dtype))
        return logits, loss, grads

    @jax.jit
    def serve_half(params, tokens):
        last, cache = JM.prefill(jcfg, params, {"tokens": tokens[:, :PRE]},
                                 max_len=S)

        def step(cache, tok):
            lg, cache = JM.decode_step(jcfg, params, tok[:, None], cache)
            return cache, lg[:, 0]

        _, lgs = jax.lax.scan(step, cache, tokens[:, PRE:].T)
        return [last] + list(lgs)

    logits, loss, grads = train_half(params, tokens, jnp.asarray(labels))
    return frozen({
        "logits": np.asarray(logits, np.float32), "loss": float(loss),
        "grads": jax.tree.map(lambda g: np.array(g, np.float32), grads),
        "decode": [np.asarray(x, np.float32)
                   for x in serve_half(params, tokens)]})


@contextlib.contextmanager
def routing_log():
    """Records the expert choices (``top_i``) of every routing call."""
    log, orig = [], TMoE.router_topk

    def recorded(p, x, mc):
        top_p, top_i = orig(p, x, mc)
        log.append(top_i.detach().numpy().copy())
        return top_p, top_i

    TMoE.router_topk = recorded
    try:
        yield log
    finally:
        TMoE.router_topk = orig


@functools.lru_cache(maxsize=None)
def port_run(arch, dtype, roomy=False):
    """The port at ``dtype``: forward logits, prefill and teacher-forced
    decode logits, loss and grads (params cast to the compute dtype, as
    its launcher trains), each with the expert choices of its routing
    calls, in numpy."""
    if roomy and tget_smoke(arch).moe is None:
        return port_run(arch, dtype)
    _, tcfg = cfgs(arch, dtype, roomy)
    np_params, _, _ = inputs(arch)
    batch = batch_of(arch)
    toks = batch["tokens"]
    out = {}
    with torch.no_grad():
        params = params_from_numpy(np_params, tcfg, "cpu")
        with routing_log() as log:
            out["logits"] = TM.forward(tcfg, params, {"tokens": toks})
        out["route_fwd"] = log
        with routing_log() as log:
            last, cache = TM.prefill(tcfg, params, {"tokens": toks[:, :PRE]},
                                     max_len=S)
            dec = [last]
            for t in range(PRE, S):
                lg, cache = TM.decode_step(tcfg, params, toks[:, t:t + 1],
                                           cache)
                dec.append(lg[:, 0])
        out["decode"], out["route_dec"] = dec, log
    tparams = train_params_from_numpy(np_params, tcfg, "cpu")
    with routing_log() as log:
        loss, grads = St.value_and_grad(tcfg, tparams, batch)
    out["route_train"] = log
    out["loss"] = float(loss)
    out["grad_dtypes"] = [g.dtype for g in tree_leaves(grads)]
    out["grads"] = [g.float().numpy() for g in tree_leaves(grads)]
    out["logits"] = out["logits"].float().numpy()
    out["decode"] = [x.float().numpy() for x in out["decode"]]
    return frozen(out)


def first_differing_position(arch, kind, L):
    """Per sequence, the first position (of ``L``) at which a routing call
    of the bf16 run chose other experts than the fp32 run; L where none
    did. ``kind`` "fwd": one call a MoE layer over all L positions; "dec":
    one call a layer over the PRE prompt positions, then one a layer for
    each decode step's position."""
    f = port_run(arch, "float32", True)[f"route_{kind}"]
    b = port_run(arch, "bfloat16", True)[f"route_{kind}"]
    assert len(f) == len(b)
    agree = np.ones((B, L), bool)
    n_layers = len(port_run(arch, "float32", True)["route_fwd"])
    for i, (x, y) in enumerate(zip(f, b)):
        same = (x == y).all(-1).reshape(B, -1)
        if kind == "fwd" or i < n_layers:
            agree[:, :same.shape[1]] &= same
        else:
            agree[:, PRE + (i - n_layers) // n_layers] &= same[:, 0]
    return [int(np.argmin(a)) if not a.all() else L for a in agree]


def grad_leaves(arch, cfg):
    """The reference's fp32 grads as the port's tree's leaves."""
    return tree_leaves(train_params_from_numpy(
        jax_run(arch)["grads"], dataclasses.replace(cfg, dtype="float32"),
        "cpu"))


def ssd_gradient_terms(arch):
    """The terms of each ssm layer's ``A_log`` grad in the port's fp32
    run: ``A_log``'s grad for head h is the sum over batch rows and
    positions of c = ∂L/∂la · la, la = dt·A the log decay (∂la/∂A_log =
    la). A probe s (ones) scales la alone: ``_ssd_chunked`` runs on x/s and
    dt·s, so dt·x and, with the D term put back, the output keep their
    values, and ∂L/∂s = c. Returns, a layer, (Σ c, Σ |c|), each [H]."""
    _, tcfg = cfgs(arch, "float32")
    params = train_params_from_numpy(inputs(arch)[0], tcfg, "cpu")
    probes, orig = [], TS._ssd_chunked

    def probed(x, dt, A, B_, C_, D, chunk):
        s = torch.ones(dt.shape, dtype=dt.dtype, requires_grad=True)
        probes.append(s)
        y, st = orig(x / s[..., None], dt * s, A, B_, C_, D, chunk)
        return y + (x - x / s[..., None]) * D[None, None, :, None], st

    TS._ssd_chunked = probed
    try:
        loss = TM.loss_fn(tcfg, params, batch_of(arch))
    finally:
        TS._ssd_chunked = orig
    assert len(probes) == tcfg.n_layers
    terms = torch.autograd.grad(loss, probes)
    return [(c.sum((0, 1)), c.abs().sum((0, 1))) for c in terms]


def leaf_names(tree, pre=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k],
                                                             f"{pre}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{pre}[{i}]")]
    return [pre]


def check_forward(arch, dtype):
    """fp32: the logits within ``fp32_tol`` of JAX's. bf16: within
    BF16_LOGITS of the port's own fp32 run, at the positions before each
    sequence's first differing expert choice (all of them for a dense
    arch)."""
    if dtype == "float32":
        near(port_run(arch, dtype)["logits"], jax_run(arch)["logits"],
             fp32_tol(arch), "logits")
        return
    got = port_run(arch, dtype, True)["logits"]
    want = port_run(arch, "float32", True)["logits"]
    upto = first_differing_position(arch, "fwd", S)
    if tget_smoke(arch).moe is None:
        assert upto == [S] * B
    for b, n in enumerate(upto):
        if n:
            near(got[b, :n], want[b, :n], BF16_LOGITS, f"logits row {b}")


def check_loss_and_grads(arch, dtype):
    """fp32: the loss and every grad leaf, elementwise, within ``fp32_tol``
    of JAX's. bf16 (grads in bf16): the loss within BF16_LOSS and every leaf
    g within BF16_GRAD of the port's own fp32 leaf f by norm, but for
    mamba2's ``A_log``.

    ``A_log``'s grad is ill-conditioned: a sum, over every batch row and
    position, of terms c of both signs that cancel (JAX's own bf16 grad
    lies 22-36% from its fp32 one). If bf16 computes each term within a
    relative error τ, the sum is off by at most τ·Σ|c|, which can be many
    times |Σ c|. So that leaf is held to ‖g − f‖ <= BF16_GRAD·‖Σ|c|‖, the
    Σ|c| of the port's fp32 run (``ssd_gradient_terms``, which also checks
    that its Σ c is the fp32 grad). A MoE's bf16 grads are compared only
    where every expert choice of the training step agrees with the fp32
    run's."""
    if dtype == "float32":
        got = port_run(arch, dtype)
        tcfg = cfgs(arch, dtype)[1]
        want = jax_run(arch)
        assert abs(got["loss"] - want["loss"]) <= fp32_tol(arch) * abs(
            want["loss"])
        jg = grad_leaves(arch, tcfg)
        assert len(got["grads"]) == len(jg)
        assert all(d == torch.float32 for d in got["grad_dtypes"])
        for i, (g, w) in enumerate(zip(got["grads"], jg)):
            near(g, w.numpy(), fp32_tol(arch), f"grad leaf {i}")
        return
    got, want = (port_run(arch, d, True) for d in ("bfloat16", "float32"))
    assert all(d == torch.bfloat16 for d in got["grad_dtypes"])
    assert abs(got["loss"] - want["loss"]) <= BF16_LOSS * abs(want["loss"])
    if not all(np.array_equal(x, y) for x, y in zip(got["route_train"],
                                                    want["route_train"])):
        return
    _, tcfg = cfgs(arch, "float32")
    names = leaf_names(train_params_from_numpy(inputs(arch)[0], tcfg,
                                               "cpu"))
    terms = iter(ssd_gradient_terms(arch) if tcfg.family == "ssm" else [])
    for name, g, f in zip(names, got["grads"], want["grads"]):
        gap = float(np.linalg.norm(g - f))
        if name.endswith("A_log"):
            total, abs_total = next(terms)
            assert float((total - torch.from_numpy(f.copy())).abs().max()) \
                <= 1e-5 * float(abs_total.max()), name
            limit = BF16_GRAD * float(abs_total.norm())
        else:
            limit = BF16_GRAD * float(np.linalg.norm(f))
        assert gap <= limit, (name, gap, limit)


def check_remat(arch):
    """Per-layer remat (a hybrid: each super-block whole, the tail
    unchecked) changes no value: loss and grads equal the run without
    it."""
    _, tcfg = cfgs(arch, "float32")
    params = train_params_from_numpy(inputs(arch)[0], tcfg, "cpu")
    batch = batch_of(arch)
    l0, g0 = St.value_and_grad(tcfg, params, batch)
    l1, g1 = St.value_and_grad(dataclasses.replace(tcfg, remat=True),
                               params, batch)
    assert float(l0) == float(l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def check_decode(arch, dtype):
    """PRE prompt tokens, then decode steps to S: recurrentgemma's 16-slot
    window cache wraps (S = 24), mamba2's prompt is two 8-token chunks.
    fp32: each step's logits within ``fp32_tol`` of JAX's. bf16: within
    BF16_LOGITS of the port's own fp32 run, for each sequence up to its
    first differing expert choice."""
    if dtype == "float32":
        got, want = port_run(arch, dtype)["decode"], jax_run(arch)["decode"]
        for i, (g, w) in enumerate(zip(got, want)):
            near(g, w, fp32_tol(arch), f"decode {PRE - 1 + i}")
        return
    got = port_run(arch, dtype, True)["decode"]
    want = port_run(arch, "float32", True)["decode"]
    upto = first_differing_position(arch, "dec", S)
    if tget_smoke(arch).moe is None:
        assert upto == [S] * B
    for i, (g, w) in enumerate(zip(got, want)):
        pos = PRE - 1 + i                 # the last token these logits read
        for b, n in enumerate(upto):
            if pos < n:
                near(g[b], w[b], BF16_LOGITS, f"decode {pos} row {b}")


def check_decode_consistency(arch):
    """fp32, as ``tests/test_models.py`` checks JAX: teacher-forced decode
    reproduces the port's parallel forward, at the reference test's 2e-2.
    Not for a MoE: its expert capacity, and so what it drops, depends on
    the tokens of the call."""
    run = port_run(arch, "float32")
    full = run["logits"]
    for i, lg in enumerate(run["decode"]):
        torch.testing.assert_close(torch.from_numpy(lg.copy()),
                                   torch.from_numpy(full[:, PRE - 1 + i]
                                                    .copy()),
                                   rtol=2e-2, atol=2e-2)
