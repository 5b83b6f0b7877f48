"""The dense and moe-layernorm families of the port (llama3.2, qwen2, olmo,
gemma, dbrx) against the JAX package on the CPU at each arch's smoke
config: configs and parameter counts of every new arch, the forward, the
loss and every grad leaf, prefill and teacher-forced decode, the layernorm
init, and ``load_balance_loss``. mamba2 and recurrentgemma are in
``tests/test_torch_ssm.py``. Inputs, runs, checks and their tolerances are
in ``tests/_torch_families.py``: fp32 held to JAX at 1e-5, bf16 held to the
port's own fp32 run, expert choices compared before a MoE's bf16 values.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_families as F  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import get_smoke_config as tget_smoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402

NEW = F.NEW
HERE = ["llama3_2-3b", "qwen2-1_5b", "olmo-1b", "gemma-2b", "dbrx-132b"]


# ---------------------------------------------------------------------------
# Configs and parameter counts
# ---------------------------------------------------------------------------


def test_archs_registered_and_later_slices_raise():
    assert ARCHS[:1] == ["granite-moe-3b-a800m"]
    assert set(NEW + ["granite-moe-3b-a800m", "deepseek-moe-paper"]) \
        == set(ARCHS)
    for arch in ("hubert-xlarge", "internvl2-26b"):
        for get in (tget, tget_smoke):
            with pytest.raises(NotImplementedError, match="audio/vlm slice"):
                get(arch)


@pytest.mark.parametrize("arch", NEW)
@pytest.mark.parametrize("smoke", [True, False])
def test_config_fields_equal_jax(arch, smoke):
    j = jget_smoke(arch) if smoke else jget(arch)
    t = tget_smoke(arch) if smoke else tget(arch)
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name
    assert t.layer_types() == j.layer_types()


@pytest.mark.parametrize("arch", NEW + ["granite-moe-3b-a800m"])
def test_param_count_equals_jax(arch):
    for j, t in ((jget(arch), tget(arch)),
                 (jget_smoke(arch), tget_smoke(arch))):
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()


@pytest.mark.parametrize("arch", NEW)
def test_init_params_has_the_jax_tree(arch):
    """The port's own init gives the leaves, shapes and fp32 leaves of the
    JAX tree converted by ``params_from_numpy``, and its matrices count
    ``param_count``."""
    tcfg = tget_smoke(arch)
    mine = TM.init_params(tcfg, torch.Generator().manual_seed(3),
                          device="cpu")
    conv = params_from_numpy(F.inputs(arch)[0], tcfg, "cpu")
    a, b = tree_leaves(mine), tree_leaves(conv)
    assert [(t.shape, t.dtype) for t in a] == [(t.shape, t.dtype) for t in b]
    if tcfg.norm == "nonparam_ln":
        assert "ln_f" not in mine
    if tcfg.norm == "layernorm":
        assert mine["ln_f_b"].dtype == torch.float32


def test_layernorm_scales_start_at_zero_in_jax_and_at_one_in_the_port():
    """The reference starts every layernorm scale at 0 (``ln1``, ``ln2``,
    ``ln_f``; ``repro/models/model.py:137-144``), which makes each dbrx
    block add 0. The port starts them at 1 (an intended difference, ROADMAP
    §3), and rmsnorm's ``1 + w`` weights at 0 in both packages."""
    for arch, scale in (("dbrx-132b", 1.0), ("llama3_2-3b", 0.0)):
        jp = JM.init_params(jget_smoke(arch), jax.random.PRNGKey(0))
        tp = TM.init_params(tget_smoke(arch),
                            torch.Generator().manual_seed(0), device="cpu")
        for name in ("ln_f", "ln1", "ln2"):
            j = np.asarray(jp[name] if name == "ln_f"
                           else jp["blocks"][name])
            t = (tp[name] if name == "ln_f"
                 else torch.stack([bp[name] for bp in tp["blocks"]]))
            assert not j.any(), name
            assert torch.equal(t.float(), torch.full(tuple(j.shape), scale)
                               ), name
    assert not np.asarray(JM.init_params(
        jget_smoke("dbrx-132b"), jax.random.PRNGKey(0))["ln_f_b"]).any()


# ---------------------------------------------------------------------------
# Forward, loss and grads; prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", HERE)
def test_forward_matches_jax(arch, dtype):
    F.check_forward(arch, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", HERE)
def test_loss_and_every_grad_leaf_match_jax(arch, dtype):
    F.check_loss_and_grads(arch, dtype)


def test_remat_gives_the_same_loss_and_grads():
    F.check_remat("llama3_2-3b")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", HERE)
def test_prefill_and_teacher_forced_decode_match_jax(arch, dtype):
    F.check_decode(arch, dtype)


@pytest.mark.parametrize("arch", [a for a in HERE if a != "dbrx-132b"])
def test_decode_consistency_with_own_forward(arch):
    F.check_decode_consistency(arch)


def test_cached_inputs_are_read_only():
    """A test that writes into a cached input raises."""
    np_params, tokens, _ = F.inputs("llama3_2-3b")
    with pytest.raises(ValueError, match="read-only"):
        tokens[0, 0] = 1
    with pytest.raises(ValueError, match="read-only"):
        np_params["embed"][0, 0] = 0.0
    with pytest.raises(ValueError, match="read-only"):
        F.port_run("llama3_2-3b", "float32")["grads"][0][...] = 0.0


# ---------------------------------------------------------------------------
# load_balance_loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_pad", [0, 2])
def test_load_balance_loss_matches_jax(n_pad):
    mc_j = JMoE.MoEConfig(n_experts=6, top_k=2, d_expert=8,
                          n_padding_experts=n_pad)
    mc_t = TMoE.MoEConfig(n_experts=6, top_k=2, d_expert=8,
                          n_padding_experts=n_pad)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((128, 16)).astype(np.float32)
    r = rng.standard_normal((16, mc_j.e_total)).astype(np.float32)
    ja, jz = JMoE.load_balance_loss(jnp.asarray(r), jnp.asarray(x), mc_j)
    ta, tz = TMoE.load_balance_loss(torch.from_numpy(r), torch.from_numpy(x),
                                    mc_t)
    F.near(ta, np.asarray(ja), 1e-5, "aux")
    F.near(tz, np.asarray(jz), 1e-5, "z")


def test_load_balance_loss_minimized_at_uniform():
    """The reference's own check (tests/test_moe_and_ep.py:137-149) on the
    port."""
    d, E = 16, 8
    mc = TMoE.MoEConfig(n_experts=E, top_k=2, d_expert=8)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (512, d)).astype(np.float32))
    r_collapsed = torch.zeros(d, E)
    r_collapsed[:, 0] = 5.0
    aux_c, z_c = TMoE.load_balance_loss(r_collapsed, x, mc)
    aux_u, z_u = TMoE.load_balance_loss(torch.zeros(d, E), x, mc)
    assert float(aux_c) > float(aux_u)
    assert abs(float(aux_u) - 1.0) < 0.2
    assert float(z_c) > float(z_u) >= 0.0
