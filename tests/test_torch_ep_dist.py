"""The port's EP over ``torch.distributed``: 4 ``gloo`` processes, one rank
each (``DistComm``: ``all_to_all_single`` for the baseline,
``batch_isend_irecv`` for the ring, each an autograd function whose
backward is the inverse transfer), on the process mesh 1x4
(``dist_mesh((1, 4))``) in both modes, each rank holding its rows as tp_sp
places them: its sequence chunk (``seq``), or for a one-token decode batch
the group's rows, which every rank routes (its cotangent shared among the
ranks, each taking 1/4), and its block of the experts. Assembled over the
ranks (chunks concatenated, a replicated input's and the router's grads
summed, the experts' blocks stacked), the forward and the grads of x, the
router, ``w_in`` and ``w_down`` must agree within 1e-6 with the
one-process ``VirtualComm`` run and within 1e-5 with the JAX
``make_moe_ep`` on a forced-host mesh."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.launch.mesh import dist_mesh, make_test_mesh  # noqa: E402
from repro_torch.models.moe import MoEConfig  # noqa: E402
from repro_torch.parallel import ep as EP  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
MC = MoEConfig(n_experts=8, top_k=2, d_expert=16)
MODES = ("baseline", "hyperparallel")
# (case, x's shape): a sequence split over the ranks, and a one-token
# decode batch every rank routes whole.
CASES = {"seq": (4, 16, 32), "decode": (4, 1, 32)}
VIRTUAL_TOL, JAX_TOL = 1e-6, 1e-5
NAMES = ("y", "dx", "drouter", "dw_in", "dw_down")


def _inputs():
    rng = np.random.default_rng(11)
    f32 = np.float32
    p = {"router": (rng.standard_normal((32, 8)) * 32 ** -0.5).astype(f32),
         "w_in": (rng.standard_normal((8, 32, 32)) * 32 ** -0.5).astype(f32),
         "w_down": (rng.standard_normal((8, 16, 32)) * 0.25).astype(f32)}
    xs = {c: (rng.standard_normal(s).astype(f32),
              rng.standard_normal(s).astype(f32)) for c, s in CASES.items()}
    return p, xs


def _run(mesh, mode, case):
    """(y, grads..., collectives) of one case on ``mesh``'s comm: the whole
    tensors on virtual ranks, this rank's on a process mesh."""
    p, xs = _inputs()
    x, g = xs[case]
    if mesh.local_rows:
        r, m = mesh.comm.rank, mesh.comm.ep
        e = MC.e_total // m
        p = dict(p, w_in=p["w_in"][r * e:(r + 1) * e],
                 w_down=p["w_down"][r * e:(r + 1) * e])
        if case == "seq":
            s = x.shape[1] // m
            x, g = x[:, r * s:(r + 1) * s], g[:, r * s:(r + 1) * s]
        else:
            g = g / np.float32(m)
    params = {k: torch.from_numpy(np.ascontiguousarray(v))
              .requires_grad_(True) for k, v in p.items()}
    x = torch.from_numpy(np.ascontiguousarray(x)).requires_grad_(True)
    impl = EP.make_moe_ep(mesh, EP.EPConfig(mode=mode, capacity_factor=2.0,
                                            use_pallas=False))
    mesh.comm.stats.reset()
    y = impl(params, x, MC)
    stats = (dict(mesh.comm.stats.counts), mesh.comm.stats.bytes)
    (y * torch.from_numpy(np.ascontiguousarray(g))).sum().backward()
    out = [y.detach(), x.grad] + [params[k].grad
                                  for k in ("router", "w_in", "w_down")]
    return dict(zip(NAMES, (t.numpy() for t in out))), stats


def _worker(rank, init, out_dir):
    dist.init_process_group("gloo", init_method=init, world_size=WORLD,
                            rank=rank)
    try:
        mesh = dist_mesh((1, WORLD))
        res = {}
        for mode in MODES:
            for case in CASES:
                got, (counts, nbytes) = _run(mesh, mode, case)
                res.update({f"{mode}/{case}/{k}": v for k, v in got.items()})
                res[f"{mode}/{case}/bytes"] = np.int64(nbytes)
                for k, v in counts.items():
                    res[f"{mode}/{case}/count/{k}"] = np.int64(v)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
        dist.barrier()
    finally:
        dist.destroy_process_group()


_JAX = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "src"); sys.path.insert(0, "tests")
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import make_test_mesh
from repro.models.moe import MoEConfig
from repro.parallel.ep import EPConfig, make_moe_ep
from test_torch_ep_dist import _inputs

p, xs = _inputs()
mc = MoEConfig(n_experts=8, top_k=2, d_expert=16)
mesh = make_test_mesh(1, 4)
out = {}
for mode in ("baseline", "hyperparallel"):
    impl = make_moe_ep(mesh, EPConfig(mode=mode, capacity_factor=2.0))
    x, g = xs["seq"]
    with jax.set_mesh(mesh):
        y = jax.jit(lambda p, x: impl(p, x, mc))(p, x)
        gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(impl(p, x, mc) * g),
                                  argnums=(0, 1)))(p, x)
    out[f"{mode}/y"], out[f"{mode}/dx"] = np.asarray(y), np.asarray(gx)
    for k in gp:
        out[f"{mode}/d{k}"] = np.asarray(gp[k])
np.savez(sys.argv[1], **out)
print("JAX_OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ep_dist")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _JAX, str(d / "jax.npz")],
                          cwd=str(REPO), env=env, capture_output=True,
                          text=True, timeout=300)
    assert "JAX_OK" in proc.stdout, proc.stderr[-3000:]
    mp.start_processes(_worker, args=(f"file://{d / 'init'}", str(d)),
                       nprocs=WORLD, join=True, start_method="spawn")
    ranks = []
    for r in range(WORLD):
        with np.load(d / f"rank{r}.npz") as z:
            ranks.append(dict(z))
    with np.load(d / "jax.npz") as z:
        return ranks, dict(z)


def _assembled(ranks, mode, case) -> dict:
    """The whole y and grads from the ranks': sequence chunks concatenated
    (``seq``) or one rank's replicated y and the ranks' shares of dx summed
    (``decode``), the router's grads summed, the experts' blocks stacked."""
    def of(k):
        return [r[f"{mode}/{case}/{k}"] for r in ranks]
    seq = case == "seq"
    if not seq:
        for y in of("y"):
            np.testing.assert_array_equal(y, of("y")[0])
    return {"y": np.concatenate(of("y"), 1) if seq else of("y")[0],
            "dx": np.concatenate(of("dx"), 1) if seq else sum(of("dx")),
            "drouter": sum(of("drouter")),
            "dw_in": np.concatenate(of("dw_in")),
            "dw_down": np.concatenate(of("dw_down"))}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", MODES)
def test_gloo_ranks_equal_the_virtual_ranks(runs, mode, case):
    """The processes' y and grads, assembled, equal the virtual ranks'
    within 1e-6, and each process moves the collectives and bytes of one
    virtual rank."""
    ranks, _ = runs
    want, (counts, nbytes) = _run(make_test_mesh(1, WORLD, device="cpu"),
                                  mode, case)
    got = _assembled(ranks, mode, case)
    for k in NAMES:
        np.testing.assert_allclose(got[k], want[k], rtol=VIRTUAL_TOL,
                                   atol=VIRTUAL_TOL, err_msg=k)
    for got in ranks:
        assert int(got[f"{mode}/{case}/bytes"]) == nbytes
        assert {k.rsplit("/", 1)[1]: int(v) for k, v in got.items()
                if k.startswith(f"{mode}/{case}/count/")} == counts


@pytest.mark.parametrize("mode", MODES)
def test_gloo_ranks_equal_jax(runs, mode):
    ranks, ref = runs
    got = _assembled(ranks, mode, "seq")
    for k in NAMES:
        np.testing.assert_allclose(got[k], ref[f"{mode}/{k}"], rtol=JAX_TOL,
                                   atol=JAX_TOL, err_msg=k)


def test_dist_comm_refuses_a_device_its_backend_does_not_serve(tmp_path):
    """A gloo group takes CPU tensors; NCCL would take CUDA tensors, and
    neither falls back to the other."""
    from repro_torch.parallel.comm import DistComm
    with pytest.raises(RuntimeError, match="init_process_group"):
        DistComm()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'i'}",
                            world_size=1, rank=0)
    try:
        comm = DistComm()
        comm.backend = "nccl"
        with pytest.raises(RuntimeError, match="needs a gloo group"):
            comm.all_to_all([torch.zeros(1, 4)])
        comm.backend = "gloo"
        y = comm.all_to_all([torch.ones(1, 4)])[0]
        assert torch.equal(y, torch.ones(1, 4))
    finally:
        dist.destroy_process_group()
