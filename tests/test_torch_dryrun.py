"""``configs/shapes.py``, the roofline and the dry run of the port against
the reference's shapes and formulas, on the CPU: the shape grid, its skip
rules and cells (31 in all), every input spec's keys, shapes and dtypes,
``model_flops``/``model_bytes``, and the work counter (a matmul's 2mnk,
the same count on meta as on the CPU, the GMM kernels' own formulas on
meta). ``repro.launch.dryrun`` is not imported: its first lines set
``XLA_FLAGS`` for 512 host devices, which would reach every later JAX test
of the same worker. Its formulas are rebuilt here from the reference's
``ModelConfig`` and ``init_cache``.
"""

import dataclasses
import functools
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import shapes as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import get_smoke_config as tget_smoke  # noqa: E402
from repro_torch.configs import shapes as TS  # noqa: E402
from repro_torch.core.hardware import H100  # noqa: E402
from repro_torch.kernels import gmm as gmm_mod  # noqa: E402
from repro_torch.kernels import gmm_swiglu as swiglu_mod  # noqa: E402
from repro_torch.kernels import gmm_swiglu_bwd as bwd_mod  # noqa: E402
from repro_torch.kernels import work  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.parallel import roofline as R  # noqa: E402

_DTYPES = {jnp.int32: torch.long, jnp.bfloat16: torch.bfloat16,
           jnp.float32: torch.float32}


def test_the_grid_equals_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in TS.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JS.SHAPES.items()}
    assert (TS.SUBQUADRATIC, TS.ENCODER_ONLY) == (JS.SUBQUADRATIC,
                                                  JS.ENCODER_ONLY)
    assert D.DRYRUN_ARCHS == JARCHS
    total = 0
    for arch in JARCHS:
        j, t = jget(arch), tget(arch)
        for s in JS.SHAPES:
            assert TS.skip_reason(t, s) == JS.skip_reason(j, s), (arch, s)
        assert TS.cells(t) == JS.cells(j)
        total += len(TS.cells(t))
    assert total == 31


@pytest.mark.parametrize("arch", JARCHS)
def test_input_specs_equal_the_reference(arch):
    """Every key, shape and dtype; the reference's int32 is ``torch.long``,
    the index type of the port's embedding and loss. Meta tensors: no
    memory."""
    j, t = jget(arch), tget(arch)
    for s in JS.cells(j):
        for bo in (None, 3):
            want = JS.input_specs(j, s, batch_override=bo)
            got = TS.input_specs(t, s, batch_override=bo)
            assert sorted(got) == sorted(want), (s, bo)
            for k, w in want.items():
                assert got[k].is_meta
                assert tuple(got[k].shape) == w.shape, (s, k)
                assert got[k].dtype == _DTYPES[w.dtype.type], (s, k)


@functools.lru_cache(maxsize=None)
def _jax_cache_bytes(arch, shape):
    sp = JS.SHAPES[shape]
    c = jax.eval_shape(lambda: JM.init_cache(jget(arch), sp.global_batch,
                                             sp.seq_len))
    return sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(c))


@pytest.mark.parametrize("arch", JARCHS)
def test_model_flops_and_bytes_equal_the_reference_formula(arch):
    """The reference's ``model_flops``/``model_bytes`` (``dryrun.py:35-56``)
    rebuilt from its own config and ``init_cache``; the decode cache's
    bytes also from the port's meta ``cache_specs``."""
    j, t = jget(arch), tget(arch)
    for s in JS.cells(j):
        sp = JS.SHAPES[s]
        tokens = sp.global_batch * (sp.seq_len if sp.kind != "decode" else 1)
        flops = (6 if sp.kind == "train" else 2) * j.active_param_count() \
            * tokens
        n = j.param_count()
        if sp.kind == "train":
            nbytes = n * (2 * 2 + 2 * 4 + 2 * 3 * 4)
        else:
            nbytes = 2.0 * n + (_jax_cache_bytes(arch, s)
                                if sp.kind == "decode" else 0)
        assert D.model_flops(t, s) == flops, s
        assert D.model_bytes(t, s) == nbytes, s


def test_h100_profile_and_roofline_terms():
    assert (H100.peak_flops("bfloat16"), H100.peak_flops(torch.float32),
            H100.hbm_bytes_per_s) == (989e12, 67e12, 3.35e12)
    rf = R.Roofline(arch="a", shape="s", mesh="1x1", chips=1,
                    flops_per_device=989e12, bytes_per_device=6.7e12,
                    collective_bytes=0.0, model_flops_global=494.5e12,
                    arg_bytes=0.0, temp_bytes=0.0, coll_counts={},
                    model_bytes_global=3.35e12)
    assert (rf.t_compute, rf.t_memory, rf.t_collective) == (1.0, 2.0, 0.0)
    assert rf.bottleneck == "memory" and rf.roofline_frac == 0.5
    assert dataclasses.replace(rf, dtype="float32").t_compute == \
        pytest.approx(989 / 67)
    assert work.bound_ms(3.35e9, 1.0, torch.bfloat16) == (1.0, "bytes")


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_a_matmul_counts_2mnk(device):
    m, k, n = 5, 7, 11
    a = torch.zeros(m, k, device=device)
    b = torch.zeros(k, n, device=device)
    with R.WorkCounter() as wc:
        c = a @ b
    assert wc.flops == 2 * m * n * k and wc.ops == 1
    assert wc.bytes == 4 * (m * k + k * n + m * n)
    assert wc.peak_live_bytes == wc.live_bytes == 4 * m * n
    del c
    assert wc.live_bytes == 0


def test_views_move_nothing_and_a_broadcast_reads_its_storage():
    x = torch.zeros(4, 8, device="meta")
    with R.WorkCounter() as wc:
        y = x.t()
        z = x[:, :1].expand(4, 8) + x
    assert wc.flops == 0 and y.is_meta
    # the add reads x[:, :1]'s storage (x's, 128 bytes) and x, writes z.
    assert wc.bytes == 128 + 128 + 128 and z.shape == (4, 8)


def test_a_smoke_forward_counts_the_same_on_meta_as_on_the_cpu():
    cfg = tget_smoke("llama3_2-3b")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16))
    counts = []
    for dev, params in (
            ("cpu", TM.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")),
            ("meta", TM.init_params(cfg, device="meta"))):
        batch = {"tokens": torch.as_tensor(toks, device=dev)}
        with torch.no_grad(), R.WorkCounter() as wc:
            TM.forward(cfg, params, batch)
        counts.append((wc.flops, wc.bytes, wc.ops))
    assert counts[0] == counts[1] and counts[0][0] > 0


def test_a_meta_gmm_call_counts_the_kernel_not_its_plain_version():
    E, C, K, F = 3, 5, 16, 8
    bf = torch.bfloat16
    x = torch.zeros(E, C, K, dtype=bf)
    w_in = torch.zeros(E, K, 2 * F, dtype=bf)
    dout = torch.zeros(E, C, F, dtype=bf)
    calls = {
        "gmm": (lambda x, w_in, dout: gmm_mod.gmm(x, w_in),
                work.gmm_work(E, C, K, 2 * F, bf)),
        "gmm_swiglu": (lambda x, w_in, dout: swiglu_mod.gmm_swiglu(x, w_in),
                       work.gmm_work(E, C, K, F, bf, two=True)),
        "gmm_swiglu_bwd": (
            lambda x, w_in, dout: bwd_mod.gmm_swiglu_bwd(
                x, w_in.reshape(E, K, 2, F), dout, out_dtype=bf),
            work.gmm_swiglu_bwd_work(E, C, K, F, bf, bf))}
    meta_args = [t.to("meta") for t in (x, w_in, dout)]
    for name, (call, (nbytes, n_ops)) in calls.items():
        with R.WorkCounter() as meta:
            call(*meta_args)
        assert meta.kernels == {name: {"calls": 1, "bytes": nbytes,
                                       "flops": n_ops}}, name
        assert (meta.flops, meta.bytes) == (n_ops, nbytes), name
        with R.WorkCounter() as cpu:         # the plain version runs
            call(x, w_in, dout)
        assert not cpu.kernels and cpu.bytes > nbytes, name


def test_the_formulas_equal_the_bound_of_the_card_checks():
    """``chip_smoke.bound``'s numbers from ``kernels.work``: granite's
    training call of ``gmm_swiglu`` is operations-bound."""
    nbytes, ops = work.gmm_work(48, 854, 1536, 512, torch.bfloat16, True)
    assert ops == 2 * 48 * 854 * 1536 * 1024
    assert nbytes == 2 * (48 * 854 * 1536 + 48 * 1536 * 1024 + 48 * 854
                          * 512)
    ms, by = work.bound_ms(nbytes, ops, torch.bfloat16)
    assert by == "operations" and ms == pytest.approx(1e3 * ops / 989e12)


# ---------------------------------------------------------------------------
# count_cell and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", JARCHS)
def test_count_cell_at_smoke_size(arch):
    """Each cell of the arch's smoke config, cut to 2 x 32 tokens: the
    counted FLOPs at least the 6ND / 2ND the step must do
    (``model_flops - lookup_flops``), a train step's kernel calls (1, 3, 1
    a MoE layer, and with remat one more forward: the smoke configs run
    without), finite positive terms."""
    cfg = tget_smoke(arch)
    for s in TS.cells(tget(arch)):
        sp = dataclasses.replace(TS.SHAPES[s], seq_len=32, global_batch=2)
        rf, dt = D.count_cell(cfg, sp)
        assert rf.mesh == "1x1" and rf.collective_bytes == 0
        assert math.isfinite(rf.t_memory) and rf.t_memory > 0, s
        assert rf.arg_bytes > 0 and rf.temp_bytes > 0, s
        if sp.kind != "decode":
            floor = rf.model_flops_global - D.lookup_flops(cfg, sp)
            assert rf.flops_per_device >= floor > 0, s
        if cfg.family == "moe" and sp.kind == "train":
            calls = {k: v["calls"] for k, v in rf.kernels.items()}
            L, r = cfg.n_layers, int(cfg.remat)
            assert calls == {"gmm_swiglu": (1 + r) * L, "gmm": (3 + r) * L,
                             "gmm_swiglu_bwd": L}
        elif cfg.family != "moe":
            assert not rf.kernels


def test_dryrun_main_counts_a_full_cell_on_the_cpu(tmp_path):
    out = tmp_path / "dry.json"
    rows, failures = D.main(["--arch", "olmo-1b", "--shape", "decode_32k",
                             "--out", str(out)])
    assert not failures and len(rows) == 1
    data = json.loads(out.read_text())
    assert data["failures"] == [] and data["rows"][0]["shape"] == \
        "decode_32k"
    assert data["rows"][0]["bottleneck"] == "memory"
    assert data["rows"][0]["flops_per_dev"] >= data["rows"][0][
        "model_flops"]


def test_run_all_in_worker_processes_equals_one_process():
    cells = (["olmo-1b", "qwen2-1_5b"], ["decode_32k", "long_500k"])
    one, f1 = D.run_all(*cells)
    two, f2 = D.run_all(*cells, workers=2)
    assert not f1 and not f2 and len(one) == 2
    for a, b in zip(one, two):
        a.pop("count_s"), b.pop("count_s")
        assert a == b
