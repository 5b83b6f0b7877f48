"""The port's flash decoding (``parallel.flash_decode``) vs the JAX
``make_flash_decode`` under shard_map at the reference's test shapes, and
vs the dense ``layers.decode_attention`` on the written cache at more."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models.layers import decode_attention  # noqa: E402
from repro_torch.parallel.flash_decode import make_flash_decode  # noqa

REPO = Path(__file__).resolve().parents[1]

_JAX = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import make_test_mesh
from repro.parallel.flash_decode import make_flash_decode

B, S, H, K, hd = 4, 32, 4, 2, 16
rng = np.random.default_rng(7)
ins = {"q": (B, 1, H, hd), "kc": (B, S, K, hd), "vc": (B, S, K, hd),
       "nk": (B, 1, K, hd), "nv": (B, 1, K, hd)}
ins = {k: rng.standard_normal(s).astype(np.float32) for k, s in ins.items()}
out = dict(ins)
for mesh in ((2, 4), (1, 4)):
    m = make_test_mesh(*mesh)
    fd = make_flash_decode(m, "model")
    with jax.set_mesh(m):
        o, kc2, vc2 = jax.jit(lambda *a: fd(*a))(
            ins["q"], ins["kc"], ins["vc"], ins["nk"], ins["nv"], 17)
    tag = f"{mesh[0]}x{mesh[1]}"
    out[f"{tag}/o"], out[f"{tag}/kc"], out[f"{tag}/vc"] = (
        np.asarray(o), np.asarray(kc2), np.asarray(vc2))
np.savez(sys.argv[1], **out)
print("FLASH_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("fd") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _JAX, str(path)],
                          cwd=str(REPO), env=env, capture_output=True,
                          text=True, timeout=300)
    assert "FLASH_OK" in proc.stdout, proc.stderr[-3000:]
    with np.load(path) as z:
        return dict(z)


@pytest.mark.parametrize("mesh", [(2, 4), (1, 4)])
def test_flash_decode_matches_jax(ref, mesh):
    """B 4, S 32, 4 heads on 2 kv heads, hd 16, length 17: the output
    within 1e-5 and the written caches exactly."""
    t = {k: torch.from_numpy(ref[k].copy())
         for k in ("q", "kc", "vc", "nk", "nv")}
    fd = make_flash_decode(make_test_mesh(*mesh, device="cpu"))
    o, kc, vc = fd(t["q"], t["kc"], t["vc"], t["nk"], t["nv"],
                   torch.tensor(17))
    tag = f"{mesh[0]}x{mesh[1]}"
    np.testing.assert_allclose(o.numpy(), ref[f"{tag}/o"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(kc.numpy(), ref[f"{tag}/kc"])
    np.testing.assert_array_equal(vc.numpy(), ref[f"{tag}/vc"])
    assert kc is t["kc"]                       # written in place


@pytest.mark.parametrize("mesh,B,S,H,K,hd,length,dtype", [
    ((1, 4), 8, 160, 24, 8, 64, 131, torch.bfloat16),   # the serving cell
    ((1, 4), 3, 16, 4, 4, 8, 0, torch.float32),         # first token
    ((2, 2), 4, 12, 6, 2, 8, 11, torch.float32),        # last slot
    ((1, 8), 2, 64, 8, 1, 32, 40, torch.float32),       # MQA
    ((2, 4), 3, 32, 4, 2, 16, 5, torch.float32),        # B % data != 0
])
def test_flash_decode_equals_dense_decode(mesh, B, S, H, K, hd, length,
                                          dtype):
    gen = torch.Generator().manual_seed(B * S + length)

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(dtype)
    q, kc, vc = rnd(B, 1, H, hd), rnd(B, S, K, hd), rnd(B, S, K, hd)
    nk, nv = rnd(B, 1, K, hd), rnd(B, 1, K, hd)
    kw, vw = kc.clone(), vc.clone()
    kw[:, length], vw[:, length] = nk[:, 0], nv[:, 0]
    want = decode_attention(q, kw, vw, torch.tensor(length + 1))
    fd = make_flash_decode(make_test_mesh(*mesh, device="cpu"))
    o, kc2, vc2 = fd(q, kc, vc, nk, nv, torch.tensor(length))
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(o, want, rtol=tol, atol=tol)
    assert torch.equal(kc2, kw) and torch.equal(vc2, vw)


def test_flash_decode_declines_unsplit_caches_and_refuses_slot_lengths():
    fd = make_flash_decode(make_test_mesh(1, 4, device="cpu"))
    q = torch.zeros(2, 1, 4, 8)
    assert fd(q, torch.zeros(2, 30, 2, 8), torch.zeros(2, 30, 2, 8),
              torch.zeros(2, 1, 2, 8), torch.zeros(2, 1, 2, 8), 3) is None
    with pytest.raises(ValueError, match="scalar cache_len"):
        fd(q, torch.zeros(2, 32, 2, 8), torch.zeros(2, 32, 2, 8),
           torch.zeros(2, 1, 2, 8), torch.zeros(2, 1, 2, 8),
           torch.tensor([3, 4]))


def test_flash_decode_combines_with_one_pmax_and_two_psums():
    mesh = make_test_mesh(1, 4, device="cpu")
    fd = make_flash_decode(mesh)
    fd(torch.zeros(2, 1, 4, 8), torch.zeros(2, 32, 2, 8),
       torch.zeros(2, 32, 2, 8), torch.zeros(2, 1, 2, 8),
       torch.zeros(2, 1, 2, 8), 3)
    assert dict(mesh.comm.stats.counts) == {"all-reduce": 3}
