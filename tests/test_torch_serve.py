"""The port's serving slice vs the JAX package as a whole: granite-moe smoke
config in fp32, JAX ``init_params`` carried over by ``params_from_numpy``."""

import dataclasses
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_margin import assert_decided  # noqa: E402
from _torch_margin import check_decisions, watch_batcher  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch.serve import ContinuousBatcher as JBatcher  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.moe import moe_grouped as jmoe_grouped  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.configs import get_smoke_config as tget_smoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCH = "granite-moe-3b-a800m"


@pytest.fixture(scope="module")
def slice_setup():
    jcfg = dataclasses.replace(jget_smoke(ARCH), dtype="float32")
    tcfg = dataclasses.replace(tget_smoke(ARCH), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("smoke", [True, False])
def test_configs_match_field_by_field(smoke):
    j = jget_smoke(ARCH) if smoke else jget_config(ARCH)
    t = tget_smoke(ARCH) if smoke else tget_config(ARCH)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.hd, t.padded_vocab) == (j.hd, j.padded_vocab)
    assert t.param_count() == j.param_count()


def test_params_from_numpy_unstacks_and_keeps_fp32_where_jax_reads_fp32(
        slice_setup):
    jcfg, tcfg, jp, _ = slice_setup
    bf = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu",
                           dtype=torch.bfloat16)
    assert len(bf["blocks"]) == tcfg.n_layers
    blk = bf["blocks"][1]
    assert blk["moe"]["router"].dtype == torch.float32
    assert blk["ln1"].dtype == bf["ln_f"].dtype == torch.float32
    assert blk["moe"]["w_in"].dtype == bf["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        blk["attn"]["wq"].float().numpy(),
        np.asarray(jp["blocks"]["attn"]["wq"][1].astype(jnp.bfloat16),
                   np.float32))


def test_forward_matches(slice_setup):
    jcfg, tcfg, jp, tp = slice_setup
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 9))
    want = JM.forward(jcfg, jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    got = TM.forward(tcfg, tp, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_prefill_and_decode_step_match(slice_setup):
    jcfg, tcfg, jp, tp = slice_setup
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, (2, 12))
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                        max_len=20)
    tl, tc = TM.prefill(tcfg, tp, {"tokens": torch.as_tensor(toks)},
                        max_len=20)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               rtol=1e-4, atol=1e-4)
    nxt = rng.integers(0, jcfg.vocab, (2, 1))
    jl2, jc2 = JM.decode_step(jcfg, jp, jnp.asarray(nxt, jnp.int32), jc)
    tl2, tc2 = TM.decode_step(tcfg, tp, torch.as_tensor(nxt), tc)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2),
                               rtol=1e-4, atol=1e-4)
    for i in range(tcfg.n_layers):
        for n in ("k", "v"):
            np.testing.assert_allclose(tc2[i][n].numpy(),
                                       np.asarray(jc2[n][i]),
                                       rtol=1e-5, atol=1e-5)
        assert int(tc2[i]["len"]) == int(jc2["len"][i]) == 13


def _drive(b, prompts, max_new):
    pending, finished = list(prompts), []
    while pending or b.active.any() or b.instant_done:
        while pending and b.admit(pending[0], prompts[pending[0]], max_new):
            pending.pop(0)
        finished += b.step()
    assert sorted(finished) == sorted(prompts)
    return b.generated


def test_continuous_batcher_greedy_tokens_identical(slice_setup):
    """6 prompts through 2 slots, with refill: the JAX batcher on the
    kernel-backed MoE (Pallas kernels, interpret mode) and the port's give
    the same greedy tokens. The port serves first; the JAX batcher is fed
    the port's tokens (``watch_batcher``), so both decide on the same
    inputs at every one of the 30 decisions, refilled requests included.
    Every decision's logits agree within 1e-4; its token is compared
    exactly where the port's top-1/top-2 gap is at least MARGIN of the
    logits' range (up to the first near-tie, the JAX batcher's own run).
    At least 25 decisions, and every token of a refilled request, must be
    compared exactly."""
    jcfg, tcfg, jp, tp = slice_setup
    rng = np.random.default_rng(2)
    prompts = {i: rng.integers(0, jcfg.vocab, 10) for i in range(6)}
    max_new = 5

    def kernel_ffn(disp, w_in, w_down, act):
        return jops.moe_expert_ffn(disp, w_in, w_down, act)

    jb = JBatcher(jcfg, jp, n_slots=2, max_len=10 + max_new + 1,
                  moe_impl=partial(jmoe_grouped, act=jcfg.act,
                                   gmm_fn=kernel_ffn))
    tb = tserve.ContinuousBatcher(tcfg, tp, n_slots=2,
                                  max_len=10 + max_new + 1, device="cpu")
    with watch_batcher(tb) as port_logs:
        got = _drive(tb, prompts, max_new)
    with watch_batcher(jb, forced=got) as jax_logs:
        assert _drive(jb, prompts, max_new) == got
    exact = check_decisions(port_logs, jax_logs, got, tol=1e-4)
    assert sum(exact.values()) >= 25, exact
    assert any(exact[rid] == max_new for rid in prompts if rid >= 2), exact
    assert tb.n_prefills == 6 and tb.n_decode_steps >= 3 * (max_new - 1)


def test_instant_path_and_defer(slice_setup):
    _, tcfg, _, tp = slice_setup
    b = tserve.ContinuousBatcher(tcfg, tp, n_slots=1, max_len=12,
                                 device="cpu")
    p = np.arange(8)
    assert b.offer(0, p, 1) == "admit"          # max_new 1: no slot taken
    assert not b.active.any() and b.step() == [0]
    assert b.offer(1, p, 3) == "admit"
    assert b.offer(2, p, 3) == "defer" and b.deferred == 1
    assert b.generated[0] == b.generated[1][:1]


def test_serve_main_on_cpu():
    b, stats = tserve.main(["--smoke", "--device", "cpu", "--requests", "5",
                            "--slots", "2", "--prompt-len", "6",
                            "--max-new", "3"])
    assert stats["requests"] == 5 and stats["tokens"] == 15
    assert stats["nonfinite_steps"] == 0
    assert all(len(v) == 3 for v in b.generated.values())


def _isolated_generate(cfg, params, prompt, max_new):
    """Greedy tokens of one request served alone (batch 1, scalar len),
    and each decision's logits."""
    toks = torch.as_tensor(np.asarray(prompt)[None, :])
    lg, cache = TM.prefill(cfg, params, {"tokens": toks},
                           max_len=len(prompt) + max_new + 1)
    out, rows = [int(torch.argmax(lg[0]))], [lg[0]]
    for _ in range(max_new - 1):
        lg, cache = TM.decode_step(cfg, params,
                                   torch.tensor([[out[-1]]]), cache)
        out.append(int(torch.argmax(lg[0, -1])))
        rows.append(lg[0, -1])
    return out, rows


@pytest.mark.parametrize("arch, prompt_len", [("mamba2-1_3b", 16),
                                              ("recurrentgemma-2b", 20)])
def test_batcher_on_ssm_and_hybrid_equals_isolated_and_jax(arch,
                                                           prompt_len):
    """Twin of ``tests/test_serving.py``'s check on the ssm and hybrid
    smoke configs, fp32: 5 prompts through 2 slots give each request the
    tokens it gets served alone, and the JAX batcher's tokens. mamba2's
    prompts are two 8-token SSD chunks; recurrentgemma's pass its 16-token
    window, so its ring wraps at prefill and again in decode. Every cache
    leaf (conv, ssm, h, ring k/v, per-slot len) goes through
    ``_scatter_slot``. Tokens are compared exactly only after every
    decision of the port's fp32 run is shown to have a top-1/top-2 gap of
    at least MARGIN of the logits' range."""
    jcfg = dataclasses.replace(jget_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(tget_smoke(arch), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(3)
    prompts = {i: rng.integers(0, jcfg.vocab, prompt_len) for i in range(5)}
    max_new = 6
    tb = tserve.ContinuousBatcher(tcfg, tp, n_slots=2,
                                  max_len=prompt_len + max_new + 1,
                                  device="cpu")
    got = _drive(tb, prompts, max_new)
    with torch.no_grad():
        alone = {rid: _isolated_generate(tcfg, tp, prompt, max_new)
                 for rid, prompt in prompts.items()}
    assert_decided([r for _, rows in alone.values() for r in rows])
    for rid in prompts:
        assert got[rid] == alone[rid][0], rid
    jb = JBatcher(jcfg, jp, n_slots=2, max_len=prompt_len + max_new + 1)
    assert got == _drive(jb, prompts, max_new)
