"""The port's SwiGLU + Add (plain versions on CPU tensors) vs the JAX Pallas
kernels in interpret mode, on the same numpy inputs; the wrappers' checks
and launch counters; the §6.1 benchmark's entry point."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.swiglu_add import swiglu_add_interleaved as jinter  # noqa
from repro.kernels.swiglu_add import swiglu_add_serial as jserial  # noqa
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import swiglu_add as sa  # noqa: E402
from repro_torch.launch import bench_swiglu_add as bench  # noqa: E402

DTYPES = ["float32", "bfloat16"]
MODES = {"serial": (jserial, sa.swiglu_add_serial),
         "interleaved": (jinter, sa.swiglu_add_interleaved)}


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=1e-5, atol=1e-5)


def _inputs(M, F, dtype, seed=0):
    """The same h [M, 2F], y [M, F] for both packages."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((M, 2 * F)).astype(np.float32)
    y = rng.standard_normal((M, F)).astype(np.float32)
    return ((jnp.asarray(h, getattr(jnp, dtype)),
             jnp.asarray(y, getattr(jnp, dtype))),
            (torch.from_numpy(h).to(getattr(torch, dtype)),
             torch.from_numpy(y).to(getattr(torch, dtype))))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("F", [2048, 64, 36])
@pytest.mark.parametrize("M", [256, 512])
@pytest.mark.parametrize("mode", list(MODES))
def test_matches_the_jax_kernel(mode, M, F, dtype):
    """Row tiles of bm = 256, as the JAX benchmark runs them; F = 36 is not
    a multiple of the CUDA kernel's 16-byte vectors."""
    jfn, tfn = MODES[mode]
    (jh, jy), (th, ty) = _inputs(M, F, dtype)
    want = np.asarray(jfn(jh, jy, interpret=True), np.float32)
    got = tfn(th, ty)
    assert got.dtype == th.dtype and tuple(got.shape) == (M, F)
    np.testing.assert_allclose(got.float().numpy(), want, **_tol(dtype))


def test_plain_versions_round_as_the_kernels_do():
    """Serial rounds g to h's dtype before the Add; interleaved rounds
    once. In fp32 the two agree; in bf16 they differ somewhere."""
    _, (h, y) = _inputs(64, 128, "float32", seed=1)
    assert torch.equal(ref.swiglu_add_serial_ref(h, y),
                       ref.swiglu_add_ref(h, y))
    hb, yb = h.bfloat16(), y.bfloat16()
    g = ref.swiglu_ref(hb)
    assert g.dtype == torch.bfloat16
    assert torch.equal(ref.swiglu_add_serial_ref(hb, yb),
                       (g.float() + yb.float()).bfloat16())
    assert not torch.equal(ref.swiglu_add_serial_ref(hb, yb),
                           ref.swiglu_add_ref(hb, yb))


def test_ops_swiglu_add_dispatches_on_mode():
    _, (h, y) = _inputs(64, 128, "bfloat16", seed=2)
    inter, serial = sa.swiglu_add_interleaved(h, y), sa.swiglu_add_serial(h, y)
    assert not torch.equal(inter, serial)
    assert torch.equal(ops.swiglu_add(h, y), inter)
    assert torch.equal(ops.swiglu_add(h, y, mode="interleaved"), inter)
    assert torch.equal(ops.swiglu_add(h, y, mode="serial"), serial)
    with pytest.raises(ValueError, match="mode"):
        ops.swiglu_add(h, y, mode="fused")


@pytest.mark.parametrize("fn", [sa.swiglu_add_serial,
                                sa.swiglu_add_interleaved])
def test_wrappers_reject_bad_operands(fn):
    h, y = torch.zeros(4, 8), torch.zeros(4, 4)
    with pytest.raises(ValueError):
        fn(torch.zeros(4, 7), torch.zeros(4, 3))          # odd 2F
    with pytest.raises(ValueError):
        fn(h, torch.zeros(4, 5))                          # F
    with pytest.raises(ValueError):
        fn(h, torch.zeros(3, 4))                          # M
    with pytest.raises(ValueError):
        fn(h[None], y)                                    # not 2-d
    with pytest.raises(TypeError):
        fn(h, y.bfloat16())
    with pytest.raises(TypeError):
        fn(h.half(), y.half())
    with pytest.raises(ValueError, match="cuda or cpu"):
        fn(h.to("meta"), y.to("meta"))


def test_cpu_calls_count_no_launches(monkeypatch):
    monkeypatch.setattr(sa, "launches_serial", 0)
    monkeypatch.setattr(sa, "launches_interleaved", 0)
    _, (h, y) = _inputs(32, 16, "float32")
    for mode in ("serial", "interleaved"):
        ops.swiglu_add(h, y, mode=mode)
    assert sa.launches_serial == sa.launches_interleaved == 0


def test_bench_needs_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([])


def test_bench_runs_on_cpu(capsys):
    """Small M: the simulator rows, then each mode checked against its
    plain version, with no time (a CPU run measures no device)."""
    out = bench.main(["--device", "cpu", "--sizes", "256,300"])
    assert out["device"] == "cpu"
    assert [r["M"] for r in out["sim"]] == list(bench.SIM_SIZES)
    assert len(out["kernels"]) == 2 * 2 * 2          # dtypes x M x modes
    for r in out["kernels"]:
        assert r["ms"] is None and r["plain_ms"] is None
        assert r["max_abs_err"] == 0.0 and r["bound_by"] == "bytes"
    assert out["calls"] == {"serial": 0, "interleaved": 0}
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert sum("_serial_sim," in ln and "prediction=ascend_a3_model" in ln
               for ln in lines) == 3
    assert sum("time=not_measured" in ln for ln in lines) == 8


def test_bytes_bound():
    """bf16 at the paper's M = 8192: interleaved moves h, y and out once
    (4 elements per output), serial also g out and back (6)."""
    ms_i, by_i = bench.bound(8192, 2048, torch.bfloat16, "interleaved")
    ms_s, by_s = bench.bound(8192, 2048, torch.bfloat16, "serial")
    assert by_i == by_s == "bytes"
    assert ms_i == pytest.approx(8192 * 2048 * 4 * 2 / 3.35e12 * 1e3)
    assert ms_s == pytest.approx(1.5 * ms_i)
    assert bench.bound(8192, 2048, torch.float32, "serial")[0] == \
        pytest.approx(2 * ms_s)
