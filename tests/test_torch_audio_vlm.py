"""The audio (hubert-xlarge) and vlm (internvl2-26b) families of the port
against the JAX package on the CPU, at each arch's smoke config: configs and
parameter counts, the parameter tree (``feat_proj``), the forward, the loss
and every grad leaf (hubert on ``{"features", "labels"}``, internvl2 with
``patches``), internvl2's prefill with patches and teacher-forced decode,
hubert's prefill step, and the launchers' refusal of the encoder.

Inputs are made once in numpy (seeded) and fed to both packages through
``convert``. fp32 is held to JAX at 1e-5 of the compared tensor's largest
value; bf16 is held to the port's own fp32 run (logits 5e-2, loss 5e-3,
each grad leaf 8e-2 by norm: ``tests/_torch_families.py``), never to JAX's
bf16. The reference starts layernorm scales at 0, which zeroes hubert's
whole stack, so every norm leaf is redrawn around its neutral value. Each
JAX run is jitted once per file (``lru_cache``), and every cached array is
read-only.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_families import (BF16_GRAD, BF16_LOGITS, BF16_LOSS,  # noqa
                             frozen, near)
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import get_smoke_config as tget_smoke  # noqa: E402
from repro_torch.configs.shapes import NO_DECODE  # noqa: E402
from repro_torch.convert import (params_from_numpy,  # noqa: E402
                                 train_params_from_numpy,
                                 train_params_to_jax)
from repro_torch.launch import serve as TServe  # noqa: E402
from repro_torch.launch import steps as St  # noqa: E402
from repro_torch.launch import train as TTrain  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim.adamw import decay_flags, tree_leaves  # noqa: E402

ARCHS = ["hubert-xlarge", "internvl2-26b"]
B, S, PRE = 2, 24, 16
TOL = 1e-5


def cfgs(arch, dtype):
    return tuple(dataclasses.replace(get(arch), dtype=dtype)
                 for get in (jget_smoke, tget_smoke))


@functools.lru_cache(maxsize=None)
def inputs(arch):
    """JAX's init (seed 0) with every norm leaf redrawn around its neutral
    value; labels, and features (hubert) or tokens and patches (internvl2)
    from a numpy generator."""
    jcfg = jget_smoke(arch)
    rng = np.random.default_rng(11)

    def norm_leaf(path, a):
        name = str(getattr(path[-1], "key", ""))
        if not name.startswith("ln"):
            return np.array(a)
        base = 1.0 if jcfg.norm == "layernorm" and not name.endswith("_b") \
            else 0.0
        return (base + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    np_params = jax.tree_util.tree_map_with_path(
        norm_leaf, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    data = {"labels": rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)}
    if jcfg.family == "audio":
        data["features"] = rng.standard_normal(
            (B, S, jcfg.feat_in)).astype(np.float32)
    else:
        data["tokens"] = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
        data["patches"] = (0.5 * rng.standard_normal(
            (B, jcfg.n_patches, jcfg.d_model))).astype(np.float32)
    return frozen((np_params, data))


def jax_batch(arch, labels=True):
    _, data = inputs(arch)
    return {k: jnp.asarray(v) for k, v in data.items()
            if labels or k != "labels"}


def port_batch(arch, labels=True, dtype=torch.float32):
    _, data = inputs(arch)
    out = {}
    for k, v in data.items():
        if k in ("labels", "tokens"):
            if labels or k != "labels":
                out[k] = torch.tensor(v, dtype=torch.long)
        else:
            out[k] = torch.tensor(v).to(dtype)
    return out


@functools.lru_cache(maxsize=None)
def jax_run(arch):
    """The reference in fp32: the forward, the loss and grads, and for the
    vlm the prefill of the patches and PRE tokens, then teacher-forced
    decode to S; in numpy."""
    jcfg, _ = cfgs(arch, "float32")
    params = jax.tree.map(jnp.asarray, inputs(arch)[0])
    batch = jax_batch(arch)

    @jax.jit
    def train_half(params, batch):
        fwd = {k: v for k, v in batch.items() if k != "labels"}
        logits = JM.forward(jcfg, params, fwd)
        loss, grads = jax.value_and_grad(
            lambda p: JM.loss_fn(jcfg, p, batch))(
                jadamw.cast_params(params, jcfg.compute_dtype))
        return logits, loss, grads

    logits, loss, grads = train_half(params, batch)
    out = {"logits": np.asarray(logits, np.float32), "loss": float(loss),
           "grads": jax.tree.map(lambda g: np.array(g, np.float32), grads)}
    if jcfg.family == "vlm":
        @jax.jit
        def serve_half(params, tokens, patches):
            last, cache = JM.prefill(
                jcfg, params, {"tokens": tokens[:, :PRE], "patches": patches},
                max_len=jcfg.n_patches + S)

            def step(cache, tok):
                lg, cache = JM.decode_step(jcfg, params, tok[:, None], cache)
                return cache, lg[:, 0]

            _, lgs = jax.lax.scan(step, cache, tokens[:, PRE:].T)
            return [last] + list(lgs)

        out["decode"] = [np.asarray(x, np.float32) for x in serve_half(
            params, batch["tokens"], batch["patches"])]
    return frozen(out)


@functools.lru_cache(maxsize=None)
def port_run(arch, dtype):
    """The port at ``dtype``: forward logits, loss and grads (params cast
    to the compute dtype, as the launcher trains), and for the vlm prefill
    and teacher-forced decode; in numpy."""
    _, tcfg = cfgs(arch, dtype)
    np_params = inputs(arch)[0]
    dt = tcfg.compute_dtype
    out = {}
    with torch.no_grad():
        params = params_from_numpy(np_params, tcfg, "cpu")
        out["logits"] = TM.forward(tcfg, params, port_batch(
            arch, labels=False, dtype=dt)).float().numpy()
        if tcfg.family == "vlm":
            b = port_batch(arch, labels=False, dtype=dt)
            toks = b["tokens"]
            last, cache = TM.prefill(
                tcfg, params, {"tokens": toks[:, :PRE],
                               "patches": b["patches"]},
                max_len=tcfg.n_patches + S)
            dec = [last]
            for t in range(PRE, S):
                lg, cache = TM.decode_step(tcfg, params, toks[:, t:t + 1],
                                           cache)
                dec.append(lg[:, 0])
            out["decode"] = [x.float().numpy() for x in dec]
    tparams = train_params_from_numpy(np_params, tcfg, "cpu")
    loss, grads = St.value_and_grad(tcfg, tparams,
                                    port_batch(arch, dtype=dt))
    out["loss"] = float(loss)
    out["grad_dtypes"] = [g.dtype for g in tree_leaves(grads)]
    out["grads"] = [g.float().numpy() for g in tree_leaves(grads)]
    return frozen(out)


# ---------------------------------------------------------------------------
# Configs, counts and the parameter tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [True, False])
def test_config_fields_and_param_count_equal_jax(arch, smoke):
    j = jget_smoke(arch) if smoke else jget(arch)
    t = tget_smoke(arch) if smoke else tget(arch)
    for f in dataclasses.fields(j):
        assert getattr(j, f.name) == getattr(t, f.name), f.name
    assert t.layer_types() == j.layer_types()
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert (t.hd, t.padded_vocab) == (j.hd, j.padded_vocab)


def test_full_widths():
    """hubert's head width 80 and vocab pad 8; internvl2's 19.86 B
    parameters (a padded vocab of 92,672)."""
    h, v = tget("hubert-xlarge"), tget("internvl2-26b")
    assert (h.hd, h.padded_vocab, h.causal, h.rope_theta) == (80, 504,
                                                              False, 0.0)
    assert (v.padded_vocab, v.param_count()) == (92672, 19862126592)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_jax_tree(arch):
    """The port's tree, stacked back to JAX's layout, has JAX's key paths,
    shapes (``feat_proj`` [feat_in, d] for audio) and every matrix is
    decayed, as the reference decays every leaf of ndim >= 2."""
    jcfg, tcfg = cfgs(arch, "float32")
    want = jax.eval_shape(lambda: JM.init_params(jcfg,
                                                 jax.random.PRNGKey(0)))
    params = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    got = train_params_to_jax(params)
    paths = jax.tree_util.tree_leaves_with_path(want)
    assert len(paths) == len(tree_leaves(got))
    for path, leaf in paths:
        t = got
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape, path
    assert ("feat_proj" in params) == (tcfg.family == "audio")
    flags = iter(decay_flags(params))
    for k in sorted(params):
        for t in tree_leaves(params[k]):
            # JAX stacks each block leaf over the layers: ndim >= 2.
            assert next(flags) == (k == "blocks" or t.dim() >= 2), k


def test_meta_init_has_shapes_and_no_values():
    """On the meta device ``init_params`` draws nothing (no generator can
    live there) and keeps every shape and dtype of the CPU init."""
    cfg = tget_smoke("internvl2-26b")
    meta = TM.init_params(cfg, device="meta")
    cpu = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for a, b in zip(tree_leaves(meta), tree_leaves(cpu)):
        assert a.is_meta and (a.shape, a.dtype) == (b.shape, b.dtype)
    with pytest.raises(ValueError, match="meta"):
        TM.init_params(cfg, torch.Generator().manual_seed(0), device="meta")


# ---------------------------------------------------------------------------
# Forward, loss and grads against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax_fp32(arch):
    near(port_run(arch, "float32")["logits"], jax_run(arch)["logits"], TOL,
         "logits")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_grad_leaf_match_jax_fp32(arch):
    got, want = port_run(arch, "float32"), jax_run(arch)
    assert abs(got["loss"] - want["loss"]) <= TOL * abs(want["loss"])
    _, tcfg = cfgs(arch, "float32")
    jg = tree_leaves(train_params_from_numpy(want["grads"], tcfg, "cpu"))
    assert len(got["grads"]) == len(jg)
    assert all(d == torch.float32 for d in got["grad_dtypes"])
    zero = [i for i, w in enumerate(jg) if not w.abs().max() > 0]
    # An encoder never reads its token embedding: that grad alone is 0.
    embed = len(tree_leaves(
        train_params_from_numpy(want["grads"], tcfg, "cpu")["blocks"]))
    assert zero == ([embed] if tcfg.family == "audio" else [])
    for i, (g, w) in enumerate(zip(got["grads"], jg)):
        near(g, w.numpy(), TOL, f"grad leaf {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_held_to_the_ports_fp32_run(arch):
    got, want = port_run(arch, "bfloat16"), port_run(arch, "float32")
    near(got["logits"], want["logits"], BF16_LOGITS, "logits")
    assert abs(got["loss"] - want["loss"]) <= BF16_LOSS * abs(want["loss"])
    assert all(d == torch.bfloat16 for d in got["grad_dtypes"])
    for i, (g, f) in enumerate(zip(got["grads"], want["grads"])):
        assert float(np.linalg.norm(g - f)) <= BF16_GRAD * float(
            np.linalg.norm(f)), f"grad leaf {i}"


def test_vlm_prefill_with_patches_and_decode_match_jax():
    """fp32: the prefill's last logits and each teacher-forced step within
    1e-5 of JAX's; bf16 within BF16_LOGITS of the port's fp32 run."""
    want = jax_run("internvl2-26b")["decode"]
    for dtype, ref, tol in (("float32", want, TOL),
                            ("bfloat16", port_run("internvl2-26b",
                                                  "float32")["decode"],
                             BF16_LOGITS)):
        got = port_run("internvl2-26b", dtype)["decode"]
        assert len(got) == len(ref) == S - PRE + 1
        for i, (g, w) in enumerate(zip(got, ref)):
            near(g, w, tol, f"{dtype} decode {PRE - 1 + i}")


def test_vlm_patches_change_the_logits_and_are_cut_off():
    """The logits cover the token region only, and the patch prefix moves
    them: without patches they differ."""
    _, tcfg = cfgs("internvl2-26b", "float32")
    params = params_from_numpy(inputs("internvl2-26b")[0], tcfg, "cpu")
    b = port_batch("internvl2-26b", labels=False)
    with torch.no_grad():
        with_p = TM.forward(tcfg, params, b)
        without = TM.forward(tcfg, params, {"tokens": b["tokens"]})
    assert with_p.shape == without.shape == (B, S, tcfg.padded_vocab)
    assert float((with_p - without).abs().max()) > 1e-3


def test_audio_encoder_is_not_causal():
    """Changing the last frame moves the first frame's logits."""
    _, tcfg = cfgs("hubert-xlarge", "float32")
    params = params_from_numpy(inputs("hubert-xlarge")[0], tcfg, "cpu")
    b = port_batch("hubert-xlarge", labels=False)
    moved = b["features"].clone()
    moved[:, -1] += 1.0
    with torch.no_grad():
        a = TM.forward(tcfg, params, b)
        c = TM.forward(tcfg, params, {"features": moved})
    assert float((a[:, 0] - c[:, 0]).abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# Steps and launchers
# ---------------------------------------------------------------------------


def test_audio_prefill_step_is_the_forward():
    _, tcfg = cfgs("hubert-xlarge", "float32")
    params = params_from_numpy(inputs("hubert-xlarge")[0], tcfg, "cpu")
    fns = St.make_steps(tcfg, make_test_mesh(1, 1, device="cpu"))
    b = port_batch("hubert-xlarge", labels=False)
    with torch.no_grad():
        logits, cache = fns.prefill_step(params, b, S)
        want = TM.forward(tcfg, params, b)
    assert cache is None
    assert torch.equal(logits, want)


def test_audio_train_step_on_features():
    """``make_train_step`` trains hubert on a features batch: a finite
    loss, and an AdamW update that moves ``feat_proj``."""
    _, tcfg = cfgs("hubert-xlarge", "float32")
    from repro_torch.optim import adamw
    params = train_params_from_numpy(inputs("hubert-xlarge")[0], tcfg,
                                     "cpu")
    before = params["feat_proj"].clone()
    state = adamw.init_opt_state(params)
    step = St.make_train_step(tcfg)
    params, state, m = step(params, state, port_batch("hubert-xlarge"))
    assert np.isfinite(float(m["loss"])) and state["step"] == 1
    assert not torch.equal(params["feat_proj"], before)


def test_launchers_refuse_the_audio_encoder():
    """Serving needs a decode step and the training launcher feeds tokens:
    both refuse hubert with a ValueError (the reference fails with a
    KeyError)."""
    with pytest.raises(ValueError, match=NO_DECODE):
        TServe.main(["--arch", "hubert-xlarge", "--smoke", "--device",
                     "cpu"])
    with pytest.raises(ValueError, match="features"):
        TTrain.main(["--arch", "hubert-xlarge", "--smoke", "--device",
                     "cpu", "--steps", "1"])
    cfg = tget_smoke("hubert-xlarge")
    with pytest.raises(ValueError, match=NO_DECODE):
        TServe.ContinuousBatcher(cfg, {}, n_slots=2, max_len=8,
                                 device="cpu")


def test_vlm_serves_and_trains_on_tokens():
    """internvl2 through the launchers on tokens alone, as the reference's
    server and launcher run it."""
    b, stats = TServe.main(["--arch", "internvl2-26b", "--smoke", "--device",
                            "cpu", "--requests", "3", "--slots", "2",
                            "--prompt-len", "6", "--max-new", "3"])
    assert stats["requests"] == 3 and stats["tokens"] == 9
    assert not stats["nonfinite_steps"]
    run = TTrain.main(["--arch", "internvl2-26b", "--smoke", "--device",
                       "cpu", "--steps", "2", "--seq", "16",
                       "--global-batch", "2"])
    assert len(run.metrics_log) == 2
    assert all(np.isfinite(float(m["loss"])) for m in run.metrics_log)
