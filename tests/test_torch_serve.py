"""The port's serving slice vs the JAX package as a whole: granite-moe smoke
config in fp32, JAX ``init_params`` carried over by ``params_from_numpy``."""

import dataclasses
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

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
    the same greedy tokens."""
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
    want = _drive(jb, prompts, max_new)
    got = _drive(tb, prompts, max_new)
    assert got == want
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
