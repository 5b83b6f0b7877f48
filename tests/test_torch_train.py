"""The port's training slice vs the JAX package: AdamW, the synthetic data
stream, the loss and its grads, and whole train steps on the granite-moe
smoke config, with inputs and params made once and fed to both."""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.configs import get_smoke_config as tget_smoke  # noqa: E402
from repro_torch.convert import (opt_state_from_numpy,  # noqa: E402
                                 train_params_from_numpy)
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.launch import steps as St  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCH = "granite-moe-3b-a800m"
KEY = jax.random.PRNGKey(0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_trees(got, want_np, cfg, rtol, atol):
    """Port tree vs a JAX tree (numpy leaves), leaf by leaf in fp32."""
    want = train_params_from_numpy(want_np, dataclasses.replace(
        cfg, dtype="float32"), "cpu")
    g, w = tadamw.tree_leaves(got), tadamw.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.detach().float().numpy(), b.numpy(),
                                   rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _opt_tree(rng, dtype):
    return {"w": rng.standard_normal((6, 8)).astype(dtype),
            "scale": rng.standard_normal((8,)).astype(dtype),
            "blocks": [{"u": rng.standard_normal((3, 4, 5)).astype(dtype)},
                       {"u": rng.standard_normal((3, 4, 5)).astype(dtype)}]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_three_steps_match_jax(dtype):
    """Clipping active (norms > 1), warm-up then cosine, decay on the
    matrices: masters, moments and params within 1e-6."""
    rng = np.random.default_rng(0)
    p0 = _opt_tree(rng, np.float32)
    oc_kw = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jd), p0)
    tp = tadamw.tree_map(lambda a: torch.from_numpy(a).to(td), p0)
    js, ts = jadamw.init_opt_state(jp), tadamw.init_opt_state(tp)
    for step in range(3):
        g = jax.tree.map(lambda a: (a * 3).astype(np.float32),
                         _opt_tree(rng, np.float32))
        jp, js, jm = jadamw.apply_updates(
            jp, jax.tree.map(lambda a: jnp.asarray(a, jd), g), js,
            jadamw.OptConfig(**oc_kw))
        tp, ts, tm = tadamw.apply_updates(
            tp, tadamw.tree_map(lambda a: torch.from_numpy(a).to(td), g), ts,
            tadamw.OptConfig(**oc_kw))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert ts["step"] == int(js["step"]) == step + 1
        for name in ("m", "v", "master"):
            for a, b in zip(tadamw.tree_leaves(ts[name]),
                            jax.tree.leaves(js[name])):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-6)
        for a, b in zip(tadamw.tree_leaves(tp), jax.tree.leaves(jp)):
            assert a.dtype == td
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32),
                                       rtol=1e-6, atol=1e-6)


def test_schedule_matches_jax():
    oc = dict(lr=3e-4, warmup_steps=5, total_steps=40, min_lr_frac=0.1)
    for step in (0, 1, 4, 5, 6, 20, 39, 40, 60):
        want = float(jadamw.schedule(jadamw.OptConfig(**oc),
                                     jnp.asarray(step, jnp.int32)))
        assert tadamw.schedule(tadamw.OptConfig(**oc), step) == \
            pytest.approx(want, rel=1e-6)


def test_accumulate_grads_matches_jax():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((5, 3)).astype(np.float32)
    xs = rng.standard_normal((4, 6, 5)).astype(np.float32)

    def jfn(p, mb):
        return jax.value_and_grad(
            lambda p: jnp.mean(jnp.square(mb["x"] @ p["w"])))(p)

    def tfn(p, mb):
        loss = torch.mean(torch.square(mb["x"] @ p["w"]))
        return loss.detach(), {"w": torch.autograd.grad(loss, p["w"])[0]}

    jl, jg = jadamw.accumulate_grads(jfn, {"w": jnp.asarray(w)},
                                     {"x": jnp.asarray(xs)})
    tl, tg = tadamw.accumulate_grads(
        tfn, {"w": torch.from_numpy(w).requires_grad_(True)},
        {"x": torch.from_numpy(xs)})
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    np.testing.assert_allclose(tg["w"].numpy(), np.asarray(jg["w"]),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,seq,batch", [(128, 16, 4), (49155, 64, 2)])
def test_synthetic_stream_is_bit_equal(vocab, seq, batch):
    jd = jpipe.SyntheticStream(jpipe.DataConfig(vocab, seq, batch))
    td = tpipe.SyntheticStream(tpipe.DataConfig(vocab, seq, batch))
    for step in (0, 1, 7):
        a, b = jd.global_batch_np(step), td.global_batch_np(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        t = td.batch(step, "cpu")
        assert t["tokens"].dtype == torch.long
        np.testing.assert_array_equal(t["labels"].numpy(), a["labels"])


# ---------------------------------------------------------------------------
# Loss and grads, train steps
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    """granite-moe smoke config in fp32, JAX params, and one batch with a
    few masked labels (< 0)."""
    jcfg = dataclasses.replace(jget_smoke(ARCH), dtype="float32")
    tcfg = dataclasses.replace(tget_smoke(ARCH), dtype="float32")
    jp = jadamw.cast_params(JM.init_params(jcfg, KEY), jnp.float32)
    b = jpipe.SyntheticStream(jpipe.DataConfig(jcfg.vocab, 24, 2)) \
        .global_batch_np(3)
    b["labels"][0, :5] = -1
    return jcfg, tcfg, jp, b


@pytest.fixture(scope="module")
def jax_loss_and_grads(smoke):
    jcfg, _, jp, b = smoke
    batch = {k: jnp.asarray(v) for k, v in b.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, batch, ce_chunk=8)))(jp)
    return float(loss), _np(grads)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(smoke, jax_loss_and_grads, remat):
    """fp32; the port's MoE runs the kernels' plain versions with their
    backward, JAX its einsum FFN. Three CE chunks of 8; remat=True runs
    each layer under torch.utils.checkpoint and must change nothing."""
    _, tcfg, jp, b = smoke
    want_loss, want_grads = jax_loss_and_grads
    cfg = dataclasses.replace(tcfg, remat=remat)
    tp = train_params_from_numpy(_np(jp), cfg, "cpu")
    batch = {k: torch.as_tensor(v, dtype=torch.long) for k, v in b.items()}
    leaves = tadamw.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    from repro_torch.models import model as TM
    loss = TM.loss_fn(cfg, tp, batch, ce_chunk=8)
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(want_loss, rel=1e-5,
                                                 abs=1e-5)
    it = iter(grads)
    _close_trees(tadamw.tree_map(lambda _: next(it), tp), want_grads, cfg,
                 rtol=1e-4, atol=1e-4)


def _five_step_trajectory(smoke, weight_decay, norm_scale=None):
    """test_train_integration._setup's step (value_and_grad + AdamW), fp32,
    from the same params and AdamW state: losses and final params within
    1e-4. ``norm_scale`` sets every norm scale (per-layer and final)."""
    jcfg, tcfg, jp, _ = smoke
    if norm_scale is not None:
        blocks = dict(jp["blocks"])
        for k in ("ln1", "ln2"):
            blocks[k] = jnp.full_like(blocks[k], norm_scale)
        jp = dict(jp, blocks=blocks,
                  ln_f=jnp.full_like(jp["ln_f"], norm_scale))
    oc = dict(lr=3e-3, warmup_steps=5, total_steps=100,
              weight_decay=weight_decay)
    joc = jadamw.OptConfig(**oc)
    js = jadamw.init_opt_state(jp)

    @jax.jit
    def jstep(params, opt_state, batch):
        loss, grads = jax.value_and_grad(
            lambda p: JM.loss_fn(jcfg, p, batch))(params)
        p2, s2, m = jadamw.apply_updates(params, grads, opt_state, joc)
        m["loss"] = loss
        return p2, s2, m

    tp = train_params_from_numpy(_np(jp), tcfg, "cpu")
    ts = opt_state_from_numpy(_np(js), tcfg, "cpu")
    tstep = St.make_train_step(tcfg, tadamw.OptConfig(**oc))
    stream = tpipe.SyntheticStream(tpipe.DataConfig(tcfg.vocab, 16, 4))
    for i in range(5):
        b = stream.global_batch_np(i)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = tstep(tp, ts, stream.batch(i, "cpu"))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-4, abs=1e-4)
    _close_trees(tp, _np(jp), tcfg, rtol=1e-4, atol=1e-4)
    _close_trees(ts["master"], _np(js["master"]), tcfg, rtol=1e-4, atol=1e-4)


def test_five_step_trajectory_matches_jax(smoke):
    """No decay."""
    _five_step_trajectory(smoke, 0.0)


def test_five_step_trajectory_matches_jax_with_weight_decay(smoke):
    """The default decay of 0.1: JAX decays every leaf of its stacked
    blocks, the per-layer norm scales [L, d] too, but not the final norm
    scale [d], and the port must follow. The smoke model's norm scales
    start at 0, where decay does nothing, so here they start at 1: five
    steps then decay them by about 9e-4, well outside 1e-4."""
    _five_step_trajectory(smoke, 0.1, norm_scale=1.0)


def test_twenty_steps_loss_falls():
    """bf16 smoke config, the launcher's params, 4 batches in turn."""
    cfg = tget_smoke(ARCH)
    from repro_torch.models import model as TM
    params = tadamw.cast_params(
        TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"),
        cfg.compute_dtype)
    state = tadamw.init_opt_state(params)
    step = St.make_train_step(cfg, tadamw.OptConfig(
        lr=3e-3, warmup_steps=5, total_steps=100, weight_decay=0.0))
    stream = tpipe.SyntheticStream(tpipe.DataConfig(cfg.vocab, 32, 8))
    losses = []
    for i in range(20):
        params, state, m = step(params, state, stream.batch(i % 4, "cpu"))
        losses.append(float(m["loss"]))
        assert np.isfinite(float(m["grad_norm"]))
    assert all(p.dtype == torch.bfloat16
               for p in tadamw.tree_leaves(params))
    assert losses[-1] < losses[0] - 0.5, losses[::4]


def test_accum_steps_average_the_microbatches(smoke):
    _, tcfg, jp, b = smoke
    batch = {k: torch.as_tensor(v, dtype=torch.long) for k, v in b.items()}
    halves = [{k: v[i:i + 1] for k, v in batch.items()} for i in (0, 1)]
    want = [float(St.value_and_grad(
        tcfg, train_params_from_numpy(_np(jp), tcfg, "cpu"), h)[0])
        for h in halves]
    tp = train_params_from_numpy(_np(jp), tcfg, "cpu")
    step = St.make_train_step(tcfg, accum_steps=2)
    _, state, m = step(tp, tadamw.init_opt_state(tp), batch)
    assert float(m["loss"]) == pytest.approx(np.mean(want), rel=1e-6)
    assert state["step"] == 1


def test_later_slices_raise():
    """``mesh``, ``ep`` and ``grad_transform`` work now; a ``sharding=``
    keyword (the sharding slice) and a mode the port does not know
    raise."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel.ep import EPConfig
    from repro_torch.parallel.compression import bf16_compress
    cfg = dataclasses.replace(tget_smoke(ARCH), moe=dataclasses.replace(
        tget_smoke(ARCH).moe, n_padding_experts=3))
    params = tadamw.cast_params(_init_params(cfg), cfg.compute_dtype)
    state = tadamw.init_opt_state(params)
    batch = tpipe.SyntheticStream(tpipe.DataConfig(cfg.vocab, 32, 2)) \
        .batch(0, "cpu")
    step = St.make_train_step(cfg, mesh=make_test_mesh(1, 4, device="cpu"),
                              ep=EPConfig(mode="baseline"),
                              grad_transform=bf16_compress)
    _, state, m = step(params, state, batch)
    assert np.isfinite(float(m["loss"])) and state["step"] == 1
    with pytest.raises(ValueError, match="mesh="):
        St.make_train_step(cfg, ep=EPConfig())
    with pytest.raises(TypeError):
        St.make_train_step(cfg, sharding=object())
    with pytest.raises(TypeError):
        St.make_steps(cfg, make_test_mesh(1, 4, device="cpu"),
                      sharding=object())
    with pytest.raises(ValueError, match="mode"):
        St.make_steps(cfg, make_test_mesh(1, 4, device="cpu"), mode="fsdp")


def _init_params(cfg):
    from repro_torch.models import model as TM
    return TM.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")


def test_train_main_on_cpu():
    run = ttrain.main(["--smoke", "--device", "cpu", "--steps", "3",
                       "--seq", "16", "--global-batch", "2"])
    assert [m["step"] for m in run.metrics_log] == [0, 1, 2]
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
               and m["step_ms"] > 0 for m in run.metrics_log)
    assert run.opt_state["step"] == 3


def test_train_main_needs_cuda_unless_asked_for_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--smoke", "--steps", "1", "--mesh", "1x4"])
    for flag, msg in ((["--mode", "ep_dp"], "need --mesh"),
                      (["--mesh", "4"], "DxM"),
                      (["--ckpt-every", "3"], "needs --ckpt-dir"),
                      (["--ckpt-dir", "ck", "--ckpt-every", "0"],
                       "at least 1")):
        with pytest.raises(SystemExit):
            ttrain.main(["--smoke", "--device", "cpu", *flag])
        assert msg in capsys.readouterr().err
    run = ttrain.main(["--smoke", "--device", "cpu", "--mesh", "1x4",
                       "--ep-mode", "baseline", "--steps", "2", "--seq",
                       "16", "--global-batch", "2"])
    assert all(np.isfinite(m["loss"]) for m in run.metrics_log)
    assert [m["collectives"] for m in run.metrics_log] == [
        {"all-to-all": 4}] * 2        # dispatch and return, x 2 layers
    assert run.params["blocks"][0]["moe"]["w_in"].shape[0] == 8   # padded


@pytest.mark.parametrize("flags, saved", [
    ([], [4]), (["--ckpt-every", "2"], [2, 4])])
def test_train_main_accepts_the_checkpoint_flags(flags, saved, tmp_path,
                                                 capsys):
    """``--ckpt-dir``, with or without ``--ckpt-every``, is accepted: the
    first run starts fresh and saves every ``--ckpt-every`` steps (default
    10) and at the last; the second resumes from the last step's checkpoint
    and has nothing left to run."""
    argv = ["--smoke", "--device", "cpu", "--steps", "4", "--seq", "16",
            "--global-batch", "2", "--ckpt-dir", str(tmp_path), *flags]
    run = ttrain.main(argv)
    assert run.resumed_from is None and run.opt_state["step"] == 4
    assert [m["step"] for m in run.metrics_log] == [0, 1, 2, 3]
    assert sorted(d for d in os.listdir(tmp_path)
                  if d.startswith("step_")) == [f"step_{s:08d}"
                                                for s in saved]
    again = ttrain.main(argv)
    assert again.resumed_from == 4 and again.opt_state["step"] == 4
    assert "resumed from step 4" in capsys.readouterr().out
    assert again.metrics_log == run.metrics_log


def test_training_conversions_cast_like_cast_params(smoke):
    _, tcfg, jp, _ = smoke
    bf = train_params_from_numpy(_np(jp), dataclasses.replace(
        tcfg, dtype="bfloat16"), "cpu")
    assert all(t.dtype == torch.bfloat16 for t in tadamw.tree_leaves(bf))
    np.testing.assert_array_equal(
        bf["blocks"][1]["moe"]["router"].float().numpy(),
        np.asarray(jp["blocks"]["moe"]["router"][1].astype(jnp.bfloat16),
                   np.float32))
    st = opt_state_from_numpy(_np(jadamw.init_opt_state(jp)), tcfg, "cpu")
    assert st["step"] == 0 and len(st["m"]["blocks"]) == tcfg.n_layers
    assert all(t.dtype == torch.float32
               for k in ("m", "v", "master")
               for t in tadamw.tree_leaves(st[k]))


# ---------------------------------------------------------------------------
# Expert parallelism: make_steps on a 1x4 mesh against JAX's
# ---------------------------------------------------------------------------

_EP_JAX = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.data.pipeline import DataConfig, SyntheticStream
from repro.launch import steps as St
from repro.launch.mesh import make_test_mesh
from repro.models import model as M
from repro.optim import adamw
from repro.parallel.ep import EPConfig

cfg = get_smoke_config("granite-moe-3b-a800m")
cfg = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
    cfg.moe, n_padding_experts=3))
mesh = make_test_mesh(1, 4)
oc = adamw.OptConfig(lr=3e-3, warmup_steps=2, total_steps=10)
stream = SyntheticStream(DataConfig(cfg.vocab, 16, 4))
out = {}
for mode in ("baseline", "hyperparallel"):
    fns = St.make_steps(cfg, mesh, opt=oc, ep=EPConfig(
        mode=mode, capacity_factor=4.0))
    p = adamw.cast_params(M.init_params(cfg, jax.random.PRNGKey(0)),
                          jnp.float32)
    s = adamw.init_opt_state(p)
    with jax.set_mesh(mesh):
        step = jax.jit(fns.train_step)
        losses = []
        for i in range(3):
            b = {k: jnp.asarray(v) for k, v in
                 stream.global_batch_np(i).items()}
            p, s, m = step(p, s, b)
            losses.append(float(m["loss"]))
        out[f"{mode}/losses"] = np.asarray(losses)
        p0 = adamw.cast_params(M.init_params(cfg, jax.random.PRNGKey(0)),
                               jnp.float32)
        toks = jnp.asarray(stream.global_batch_np(7)["tokens"][:, :8])
        logits, cache = fns.prefill_step(p0, {"tokens": toks}, 16)
        out[f"{mode}/prefill"] = np.asarray(logits)
        nxt = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        for i in range(2):
            lg, cache = jax.jit(fns.decode_step)(p0, nxt, cache)
            out[f"{mode}/decode{i}"] = np.asarray(lg)
            nxt = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
# sharded_batch over a 2x2 mesh: the batch split over data.
m22 = make_test_mesh(2, 2)
sh = jax.sharding.NamedSharding(m22, jax.sharding.PartitionSpec("data", None))
arr = SyntheticStream(DataConfig(cfg.vocab, 16, 6)).sharded_batch(
    5, m22, {"tokens": sh, "labels": sh})
for k in ("tokens", "labels"):
    out[f"sharded/{k}"] = np.asarray(arr[k])
    for s_ in arr[k].addressable_shards:
        out[f"sharded/{k}/{s_.index[0].start or 0}"] = np.asarray(s_.data)
np.savez(sys.argv[1], **out)
print("EP_STEPS_OK")
"""


@pytest.fixture(scope="module")
def jax_ep_steps(tmp_path_factory):
    import os
    import subprocess
    import sys
    from pathlib import Path
    path = tmp_path_factory.mktemp("ep_steps") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _EP_JAX, str(path)],
        cwd=str(Path(__file__).resolve().parents[1]), env=env,
        capture_output=True, text=True, timeout=300)
    assert "EP_STEPS_OK" in proc.stdout, proc.stderr[-3000:]
    with np.load(path) as z:
        return dict(z)


def _ep_cfgs():
    jcfg, tcfg = (dataclasses.replace(c, dtype="float32",
                                      moe=dataclasses.replace(
                                          c.moe, n_padding_experts=3))
                  for c in (jget_smoke(ARCH), tget_smoke(ARCH)))
    return jcfg, tcfg


@pytest.mark.parametrize("mode", ["baseline", "hyperparallel"])
def test_make_steps_ep_train_matches_jax(jax_ep_steps, mode):
    """Three fp32 steps of ``make_steps(...).train_step`` with EP over a
    1x4 mesh (capacity factor 4, the experts padded to 8), the port's
    expert FFN through the kernels' plain versions and their backward:
    losses within 1e-5 of JAX's."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel.ep import EPConfig
    jcfg, tcfg = _ep_cfgs()
    jp = jadamw.cast_params(JM.init_params(jcfg, KEY), jnp.float32)
    tp = train_params_from_numpy(_np(jp), tcfg, "cpu")
    ts = opt_state_from_numpy(_np(jadamw.init_opt_state(jp)), tcfg, "cpu")
    mesh = make_test_mesh(1, 4, device="cpu")
    fns = St.make_steps(tcfg, mesh, opt=tadamw.OptConfig(
        lr=3e-3, warmup_steps=2, total_steps=10), ep=EPConfig(
        mode=mode, capacity_factor=4.0))
    assert fns.ep_cfg.mode == mode and fns.dropless is None
    stream = tpipe.SyntheticStream(tpipe.DataConfig(tcfg.vocab, 16, 4))
    losses = []
    for i in range(3):
        tp, ts, m = fns.train_step(tp, ts, stream.sharded_batch(i, mesh,
                                                                "cpu"))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jax_ep_steps[f"{mode}/losses"],
                               rtol=1e-5, atol=1e-5)
    assert mesh.comm.stats.counts[
        "all-to-all" if mode == "baseline" else "collective-permute"] > 0


@pytest.mark.parametrize("mode", ["baseline", "hyperparallel"])
def test_make_steps_ep_serving_with_flash_decoding_matches_jax(
        jax_ep_steps, mode):
    """``prefill_step`` through EP, then two ``decode_step`` calls with
    flash decoding over the 1x4 mesh (every rank routing the whole
    decode batch): logits within 1e-4 of JAX's, and equal to the dense
    decode of a step without a mesh. Each step is fed the token JAX's
    greedy decision picked, not the port's."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as TM
    from repro_torch.parallel.ep import EPConfig, make_moe_ep
    jcfg, tcfg = _ep_cfgs()
    tp = train_params_from_numpy(_np(jadamw.cast_params(
        JM.init_params(jcfg, KEY), jnp.float32)), tcfg, "cpu")
    mesh = make_test_mesh(1, 4, device="cpu")
    fns = St.make_steps(tcfg, mesh, ep=EPConfig(mode=mode,
                                                capacity_factor=4.0))
    toks = torch.as_tensor(tpipe.SyntheticStream(tpipe.DataConfig(
        tcfg.vocab, 16, 4)).global_batch_np(7)["tokens"][:, :8])
    plain_ep = make_moe_ep(make_test_mesh(1, 4, device="cpu"), EPConfig(
        mode=mode, capacity_factor=4.0), tcfg.act)
    with torch.no_grad():
        logits, cache = fns.prefill_step(tp, {"tokens": toks}, 16)
        np.testing.assert_allclose(logits.numpy(),
                                   jax_ep_steps[f"{mode}/prefill"],
                                   rtol=1e-4, atol=1e-4)
        # Fed JAX's tokens, so no greedy decision is compared exactly.
        nxt = torch.from_numpy(jax_ep_steps[f"{mode}/prefill"]
                               .argmax(-1))[:, None]
        dense = [{k: v.clone() for k, v in c.items()} for c in cache]
        for i in range(2):
            before = mesh.comm.stats.counts["all-reduce"]
            lg, cache = fns.decode_step(tp, nxt, cache)
            assert mesh.comm.stats.counts["all-reduce"] == \
                before + 3 * tcfg.n_layers      # flash decoding ran
            np.testing.assert_allclose(lg.numpy(),
                                       jax_ep_steps[f"{mode}/decode{i}"],
                                       rtol=1e-4, atol=1e-4)
            ld, dense = TM.decode_step(tcfg, tp, nxt, dense,
                                       moe_impl=plain_ep)
            torch.testing.assert_close(lg, ld, rtol=1e-5, atol=1e-5)
            nxt = torch.from_numpy(jax_ep_steps[f"{mode}/decode{i}"]
                                   [:, -1].argmax(-1))[:, None]



def test_sharded_batch_matches_jax(jax_ep_steps):
    """Over a 2x2 mesh: the whole batch built group by group equals JAX's
    global array, and each data group's rows of it equal the shards JAX's
    callback built for that group."""
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh(2, 2, device="cpu")
    stream = tpipe.SyntheticStream(tpipe.DataConfig(128, 16, 6))
    whole = stream.sharded_batch(5, mesh, "cpu")
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(whole[k].numpy(),
                                      jax_ep_steps[f"sharded/{k}"])
        for g in range(2):
            rows = whole[k][3 * g:3 * (g + 1)]
            assert rows.shape == (3, 16)
            np.testing.assert_array_equal(
                rows.numpy(), jax_ep_steps[f"sharded/{k}/{3 * g}"])
    with pytest.raises(ValueError, match="data groups"):
        tpipe.SyntheticStream(tpipe.DataConfig(128, 16, 5)).sharded_batch(
            0, mesh, "cpu")


@pytest.mark.parametrize("arch", ["llama3_2-3b", "recurrentgemma-2b"])
def test_one_adamw_step_on_a_dense_and_the_hybrid_stack_matches_jax(arch):
    """One train step, fp32, from the same params and AdamW state (weight
    decay 0.1, lr 1e-2 from the first step), in two halves.

    The grads: the loss within 1e-5 and every grad leaf within 1e-5 of
    JAX's largest value of the leaf (1e-4 for recurrentgemma, whose
    log-depth scan sums in another order than ``associative_scan``).

    The update: both packages' ``apply_updates`` from the same grads, JAX's.
    Adam's first step moves an entry by lr·g/(|g| + eps), so a grad near
    zero that differs by fp32 noise would move it by any part of lr; from
    the same grads both run the same fp32 ops, and differ only in the
    order of the global norm's sum (a relative 1e-7 in the clip scale,
    which moves lr·g/(|g| + eps) by at most that part of lr) and in the
    rounding of each op. So params and masters agree within 1e-5 of each
    leaf's largest value. Decay moves an entry by lr·0.1·|w|: a norm scale
    (here started at 1) by 1e-3, rglru's Λ (about -4 to -9) by 4e-3 to
    9e-3, far outside the tolerance. In the hybrid stack JAX stacks the
    pattern's layers over super-blocks and keeps the tail unstacked, so a
    1-d leaf (``ln1``, ``lam``, ``gate_a_b``, ...) is decayed in a
    super-block and not in the tail."""
    from repro_torch.configs import get_smoke_config as smoke_cfg
    jcfg = dataclasses.replace(jget_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(smoke_cfg(arch), dtype="float32")
    tol = 1e-4 if tcfg.family == "hybrid" else 1e-5

    def ones_for_norms(path, a):
        name = str(getattr(path[-1], "key", ""))
        return jnp.ones_like(a) if name.startswith("ln") else a

    jp = jax.tree_util.tree_map_with_path(ones_for_norms,
                                          JM.init_params(jcfg, KEY))
    oc = dict(lr=1e-2, warmup_steps=1, total_steps=100, weight_decay=0.1)
    joc = jadamw.OptConfig(**oc)
    js = jadamw.init_opt_state(jp)
    tp = train_params_from_numpy(_np(jp), tcfg, "cpu")
    ts = opt_state_from_numpy(_np(js), tcfg, "cpu")
    b = jpipe.SyntheticStream(jpipe.DataConfig(jcfg.vocab, 20, 2)) \
        .global_batch_np(0)
    loss, jg = jax.jit(jax.value_and_grad(
        lambda p, batch: JM.loss_fn(jcfg, p, batch)))(
            jp, {k: jnp.asarray(v) for k, v in b.items()})
    tloss, tg = St.value_and_grad(
        tcfg, tp, {k: torch.as_tensor(v, dtype=torch.long)
                   for k, v in b.items()})
    assert float(tloss) == pytest.approx(float(loss), rel=1e-5)
    jg_t = train_params_from_numpy(_np(jg), tcfg, "cpu")
    for a, c in zip(tadamw.tree_leaves(tg), tadamw.tree_leaves(jg_t)):
        assert float((a - c).abs().max()) <= tol * float(c.abs().max())

    jp, js, _ = jax.jit(lambda p, g, s: jadamw.apply_updates(p, g, s, joc))(
        jp, jg, js)
    with torch.no_grad():
        tadamw.apply_updates(tp, jg_t, ts, tadamw.OptConfig(**oc))
    for got, want in ((tp, jp), (ts["master"], js["master"])):
        g = tadamw.tree_leaves(got)
        w = tadamw.tree_leaves(train_params_from_numpy(_np(want), tcfg,
                                                       "cpu"))
        assert len(g) == len(w)
        for a, c in zip(g, w):
            err = float((a.detach() - c).abs().max())
            assert err <= 1e-5 * float(c.abs().max()), err
    if tcfg.family == "hybrid":
        flags = tadamw.decay_flags(tp)
        sup = tadamw.decay_flags({"super": tp["super"]})
        tail = tadamw.decay_flags({"tail": tp["tail"]})
        assert all(sup)
        assert not all(tail) and any(tail)
        assert tadamw.decay_flags({"tail": tp["tail"]}) == [
            t.dim() >= 2 for t in tadamw.tree_leaves(tp["tail"])]
        assert len(flags) == len(tadamw.tree_leaves(tp))
