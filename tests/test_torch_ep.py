"""The port's expert parallelism (``parallel.ep`` on ``VirtualComm``) vs the
JAX ``make_moe_ep`` under shard_map on forced host devices.

The JAX side runs once, in a subprocess with 8 host devices, on inputs made
from a numpy seed; it writes every reference into one ``.npz`` that a
module fixture reads. Both modes, meshes 1x4 and 2x4, fp32: the forward
within 1e-5 and the grads of x, the router, ``w_in`` and ``w_down`` within
1e-4, then the kernel route, drops, ``dp_batch``, replicated decode and the
plan-sized ring (exact, bucketed, per link class, stale)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_margin import decided  # noqa: E402
from repro_torch.core.hardware import Topology  # noqa: E402
from repro_torch.core.routing import RoutingPlan  # noqa: E402
from repro_torch.launch.mesh import (make_test_mesh, dp_axes,  # noqa: E402
                                     model_axis_size)
from repro_torch.models.moe import (MoEConfig, moe_grouped,  # noqa: E402
                                    router_topk)
from repro_torch.parallel import ep as EP  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
MC = MoEConfig(n_experts=8, top_k=2, d_expert=16)
D = 32
MODES = ("baseline", "hyperparallel")

_JAX = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from repro.core.hardware import Topology
from repro.core.routing import RoutingPlan
from repro.launch.mesh import make_test_mesh
from repro.models.moe import MoEConfig, router_topk
from repro.parallel import ep as EP

out_path = sys.argv[1]
mc = MoEConfig(n_experts=8, top_k=2, d_expert=16)
d = 32
rng = np.random.default_rng(0)
f32 = np.float32
P = {"router": (rng.standard_normal((d, 8)) * d ** -0.5).astype(f32),
     "w_in": (rng.standard_normal((8, d, 32)) * d ** -0.5).astype(f32),
     "w_down": (rng.standard_normal((8, 16, d)) * 0.25).astype(f32)}
X = {"x": rng.standard_normal((4, 16, d)).astype(f32),
     "xbig": rng.standard_normal((2, 128, d)).astype(f32),
     "x8": rng.standard_normal((8, 4, d)).astype(f32),
     "xdec": rng.standard_normal((4, 1, d)).astype(f32)}
out = {f"p_{k}": v for k, v in P.items()}
out.update({f"in_{k}": v for k, v in X.items()})
meshes = {"1x4": make_test_mesh(1, 4), "2x4": make_test_mesh(2, 4)}
jp = {k: jnp.asarray(v) for k, v in P.items()}


def run(name, mesh, epc, xname, grads=True, **kw):
    x = jnp.asarray(X[xname])
    impl = EP.make_moe_ep(meshes[mesh], epc, **kw)
    g = rng.standard_normal(X[xname].shape).astype(f32)
    with jax.set_mesh(meshes[mesh]):
        y = jax.jit(lambda p, x: impl(p, x, mc))(jp, x)
        out[f"{name}/y"] = np.asarray(y)
        out[f"{name}/g"] = g
        if grads:
            gp, gx = jax.jit(jax.grad(
                lambda p, x: jnp.sum(impl(p, x, mc) * g), argnums=(0, 1)))(
                    jp, x)
            out[f"{name}/dx"] = np.asarray(gx)
            for k in gp:
                out[f"{name}/d{k}"] = np.asarray(gp[k])


for mode in ("baseline", "hyperparallel"):
    for mesh in meshes:
        run(f"{mesh}_{mode}", mesh, EP.EPConfig(mode=mode,
                                                capacity_factor=2.0), "x")
    run(f"pallas_{mode}", "2x4", EP.EPConfig(
        mode=mode, capacity_factor=2.0, use_pallas=True), "x", grads=False)
    run(f"drop_{mode}", "1x4", EP.EPConfig(mode=mode, capacity_factor=0.25),
        "xbig")
    run(f"dpbatch_{mode}", "2x4", EP.EPConfig(mode=mode, dp_batch=True),
        "x8")
    run(f"decode_{mode}", "2x4", EP.EPConfig(mode=mode), "xdec")

# Plan-sized rings on mesh 1x4: each rank routes its sequence block.
xr = X["xbig"]
top_i = np.stack([np.asarray(router_topk(
    jp["router"], jnp.asarray(xr[:, 32 * r:32 * (r + 1)].reshape(-1, d)),
    mc)[1]) for r in range(4)])
C = EP._pair_capacity(64, mc, 4, 1.25)
plan = EP.plan_from_dispatch(top_i, mc, 4, C)
out["plan/top_i"], out["plan/C"] = top_i, np.int64(C)
out["plan/counts"] = np.asarray(plan.counts)
topo = Topology(ranks_per_node=2)
stale = RoutingPlan.from_counts(np.asarray(plan.counts) // 2)
cases = {"exact": dict(plan=plan), "linear4": dict(plan=plan,
                                                   bucket="linear:4"),
         "topo": dict(plan=plan, topology=topo, bucket=4,
                      inter_bucket="geometric:8"),
         "stale": dict(plan=stale)}
for name, kw in cases.items():
    run(f"plan_{name}", "1x4", EP.EPConfig(mode="hyperparallel"), "xbig",
        **kw)

# Pair capacities and a dispatch plan at assorted sizes.
pc = [(t, e, k, cf) for t in (1, 7, 64, 1024, 8192) for e, k in
      ((8, 2), (48, 8), (32, 8)) for cf in (0.25, 1.25, 4.0, 8.0)]
out["pair_args"] = np.asarray(pc, dtype=np.float64)
out["pair_caps"] = np.asarray([EP._pair_capacity(
    int(t), MoEConfig(n_experts=int(e), top_k=int(k), d_expert=8), 4, cf)
    for t, e, k, cf in pc])
np.savez(out_path, **out)
print("EP_REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("ep") / "ref.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _JAX, str(path)],
                          cwd=str(REPO), env=env, capture_output=True,
                          text=True, timeout=300)
    assert "EP_REFERENCE_OK" in proc.stdout, proc.stderr[-3000:]
    with np.load(path) as z:
        return dict(z)


def _params(ref, grad=False):
    return {k: torch.from_numpy(ref[f"p_{k}"]).requires_grad_(grad)
            for k in ("router", "w_in", "w_down")}


def _run(ref, name, mesh, epc, xname, grads=True, **kw):
    """The port on the case's inputs: (y, {grad name: grad})."""
    params = _params(ref, grads)
    x = torch.from_numpy(ref[f"in_{xname}"]).requires_grad_(grads)
    impl = EP.make_moe_ep(make_test_mesh(*mesh, device="cpu"), epc, **kw)
    y = impl(params, x, MC)
    if not grads:
        return y.detach(), {}
    (y * torch.from_numpy(ref[f"{name}/g"])).sum().backward()
    return y.detach(), {"dx": x.grad, **{f"d{k}": p.grad
                                         for k, p in params.items()}}


def _check(ref, name, y, grads):
    np.testing.assert_allclose(y.numpy(), ref[f"{name}/y"], rtol=FWD_TOL,
                               atol=FWD_TOL)
    assert float(np.abs(ref[f"{name}/y"]).max()) > 0.1
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[f"{name}/{k}"],
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", [(1, 4), (2, 4)])
def test_ep_matches_jax_forward_and_grads(ref, mesh, mode):
    name = f"{mesh[0]}x{mesh[1]}_{mode}"
    y, grads = _run(ref, name, mesh, EP.EPConfig(
        mode=mode, capacity_factor=2.0, use_pallas=False), "x")
    assert set(grads) == {"dx", "drouter", "dw_in", "dw_down"}
    _check(ref, name, y, grads)


@pytest.mark.parametrize("mode", MODES)
def test_kernel_route_matches_jax_pallas_forward(ref, mode):
    """``use_pallas=True`` runs ``moe_expert_ffn`` in each shard (its plain
    versions on the CPU), against the JAX Pallas kernels in interpret
    mode."""
    name = f"pallas_{mode}"
    y, _ = _run(ref, name, (2, 4), EP.EPConfig(
        mode=mode, capacity_factor=2.0, use_pallas=True), "x", grads=False)
    _check(ref, name, y, {})


@pytest.mark.parametrize("mode", MODES)
def test_kernel_route_grads_equal_the_plain_route(ref, mode):
    """The kernels' backward (the plain versions of its steps here)
    gives the plain FFN's grads, where the JAX kernels have no VJP."""
    epc = EP.EPConfig(mode=mode, capacity_factor=2.0)
    _, got = _run(ref, f"1x4_{mode}", (1, 4), epc, "x")
    _, want = _run(ref, f"1x4_{mode}", (1, 4), EP.EPConfig(
        mode=mode, capacity_factor=2.0, use_pallas=False), "x")
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_drops_follow_the_reference_slot_order(ref, mode):
    """capacity_factor 0.25 on 64 tokens a rank: C = 8 of ~16 choices a
    (source, expert) pair, so about half are dropped; which ones depends
    on the cumsum order of each rank's (b, s) rows."""
    name = f"drop_{mode}"
    epc = EP.EPConfig(mode=mode, capacity_factor=0.25, use_pallas=False)
    y, grads = _run(ref, name, (1, 4), epc, "xbig")
    _check(ref, name, y, grads)
    full, _ = _run(ref, name, (1, 4), EP.EPConfig(
        mode=mode, capacity_factor=8.0, use_pallas=False), "xbig",
        grads=False)
    assert float((y - full).abs().max()) > 0.1      # something was dropped


@pytest.mark.parametrize("mode", MODES)
def test_dp_batch_and_replicated_decode(ref, mode):
    """``dp_batch`` shards 8 rows over all 8 ranks of the 2x4 mesh; a
    one-token decode batch splits over data and is replicated over model,
    each rank routing its group's whole batch."""
    for name, epc, xname in (
            (f"dpbatch_{mode}", EP.EPConfig(mode=mode, dp_batch=True,
                                           use_pallas=False), "x8"),
            (f"decode_{mode}", EP.EPConfig(mode=mode, use_pallas=False),
             "xdec")):
        y, grads = _run(ref, name, (2, 4), epc, xname)
        _check(ref, name, y, grads)


def test_pair_capacity_and_dispatch_plan_match_jax(ref):
    got = [EP._pair_capacity(int(t), MoEConfig(
        n_experts=int(e), top_k=int(k), d_expert=8), 4, cf)
        for t, e, k, cf in ref["pair_args"]]
    np.testing.assert_array_equal(got, ref["pair_caps"])
    # granite at ep = 4 on 4096 tokens: 688 rows a pair (PERF.md §4).
    assert EP._pair_capacity(1024, MoEConfig(
        n_experts=40, top_k=8, d_expert=512, n_padding_experts=8),
        4, 4.0) == 688
    router = torch.from_numpy(ref["p_router"])
    x = torch.from_numpy(ref["in_xbig"])
    xs = [x[:, 32 * r:32 * (r + 1)].reshape(-1, D) for r in range(4)]
    top_i = torch.stack([router_topk(router, xr, MC)[1] for xr in xs])
    # Expert choices are compared exactly only on rows whose ranked logits
    # (the k + 1 largest) are at least MARGIN of the row's range apart.
    ok = decided(torch.stack([xr @ router for xr in xs]), MC.top_k).numpy()
    assert ok.mean() >= 0.9, ok.mean()
    np.testing.assert_array_equal(top_i.numpy()[ok], ref["plan/top_i"][ok])
    top_i = torch.from_numpy(ref["plan/top_i"].copy())
    plan = EP.plan_from_dispatch(top_i, MC, 4, int(ref["plan/C"]))
    np.testing.assert_array_equal(plan.counts, ref["plan/counts"])
    with pytest.raises(ValueError, match="divisible"):
        EP.plan_from_dispatch(top_i[:3], MoEConfig(8, 2, 16), 3, 8)


def _plan_kw(ref, name):
    plan = RoutingPlan.from_counts(ref["plan/counts"])
    return {"exact": dict(plan=plan),
            "linear4": dict(plan=plan, bucket="linear:4"),
            "topo": dict(plan=plan, topology=Topology(ranks_per_node=2),
                         bucket=4, inter_bucket="geometric:8"),
            "stale": dict(plan=RoutingPlan.from_counts(
                ref["plan/counts"] // 2))}[name]


@pytest.mark.parametrize("name", ["exact", "linear4", "topo", "stale"])
def test_plan_sized_ring_matches_jax(ref, name):
    """The ring's chunks cut to the plan's caps: exact and bucketed plans
    give the full-capacity result; a stale plan that undercounts drops
    its overflow rows exactly as the reference does."""
    kw = _plan_kw(ref, name)
    key = f"plan_{name}"
    epc = EP.EPConfig(mode="hyperparallel", use_pallas=False)
    y, grads = _run(ref, key, (1, 4), epc, "xbig", **kw)
    _check(ref, key, y, grads)
    full, _ = _run(ref, key, (1, 4), epc, "xbig", grads=False)
    if name == "stale":
        assert float((y - full).abs().max()) > 0.1
    else:
        torch.testing.assert_close(y, full, rtol=1e-6, atol=1e-6)


def test_plan_caps_skip_padding_steps_and_count_the_ring():
    """A step whose cap is 0 moves nothing and runs no FFN; the comm counts
    two permutes a ring step that runs and the bytes of its chunks."""
    mesh = make_test_mesh(1, 4, device="cpu")
    counts = np.zeros((4, 4, 2), dtype=np.int64)
    for s in range(4):
        counts[s, s] = 3                  # every source keeps its tokens
        counts[s, (s + 2) % 4, 0] = 5     # ... and sends some two hops on
    plan = RoutingPlan.from_counts(counts)
    assert EP.ring_chunk_caps(plan, 4) == (3, 0, 5, 0)
    calls = []
    epc = EP.EPConfig(mode="hyperparallel", use_pallas=False)
    impl = EP.make_moe_ep(mesh, epc, plan=plan)
    orig = EP.expert_ffn
    try:
        EP.expert_ffn = lambda *a: calls.append(a[2].shape) or orig(*a)
        rng = np.random.default_rng(3)
        params = {"router": torch.from_numpy(
            rng.standard_normal((D, 8)).astype(np.float32)),
            "w_in": torch.zeros(8, D, 32), "w_down": torch.zeros(8, 16, D)}
        impl(params, torch.zeros(1, 8, D), MC)
    finally:
        EP.expert_ffn = orig
    assert calls == [(2, 3, D)] * 4 + [(2, 5, D)] * 4
    assert dict(mesh.comm.stats.counts) == {"collective-permute": 2}
    assert mesh.comm.stats.bytes == 2 * 2 * 5 * D * 4


def test_baseline_counts_two_all_to_alls_without_the_local_block():
    mesh = make_test_mesh(1, 4, device="cpu")
    impl = EP.make_moe_ep(mesh, EP.EPConfig(mode="baseline",
                                            use_pallas=False))
    params = {"router": torch.zeros(D, 8), "w_in": torch.zeros(8, D, 32),
              "w_down": torch.zeros(8, 16, D)}
    impl(params, torch.zeros(2, 16, D), MC)
    C = EP._pair_capacity(8, MC, 4, 1.25)
    assert dict(mesh.comm.stats.counts) == {"all-to-all": 2}
    assert mesh.comm.stats.bytes == 2 * 3 * 2 * C * D * 4


@pytest.mark.parametrize("mode", MODES)
def test_ep_equals_single_device_moe_without_drops(mode):
    """At a capacity that drops nothing, EP on the 2x4 mesh equals
    ``moe_grouped`` on one device."""
    rng = np.random.default_rng(5)
    mc = MoEConfig(n_experts=8, top_k=2, d_expert=16)
    params = {"router": torch.from_numpy(rng.standard_normal((D, 8))
                                         .astype(np.float32)),
              "w_in": torch.from_numpy(rng.standard_normal((8, D, 32))
                                       .astype(np.float32) * 0.2),
              "w_down": torch.from_numpy(rng.standard_normal((8, 16, D))
                                         .astype(np.float32) * 0.25)}
    x = torch.from_numpy(rng.standard_normal((4, 8, D)).astype(np.float32))
    impl = EP.make_moe_ep(make_test_mesh(2, 4, device="cpu"), EP.EPConfig(
        mode=mode, capacity_factor=16.0, use_pallas=False))
    torch.testing.assert_close(impl(params, x, mc),
                               moe_grouped(params, x, mc, cap=64),
                               rtol=1e-5, atol=1e-5)


def test_mesh_helpers_and_refusals():
    mesh = make_test_mesh(2, 4, device="cpu")
    assert dp_axes(mesh) == ("data",) and model_axis_size(mesh) == 4
    assert mesh.dp_size == 2 and mesh.comm.ranks == [0, 1, 2, 3]
    from repro_torch.launch.mesh import make_mesh, mesh_dims
    m3 = make_mesh(mesh_dims("2x1x4"), device="cpu")
    assert m3.axis_names == ("pod", "data", "model") and m3.dp_size == 2
    for bad in ("4", "2x0", "axb", "1x2x3x4"):
        with pytest.raises(ValueError, match="DxM"):
            mesh_dims(bad)
    impl = EP.make_moe_ep(mesh, EP.EPConfig(use_pallas=False))
    params = {"router": torch.zeros(D, 6), "w_in": torch.zeros(6, D, 32),
              "w_down": torch.zeros(6, 16, D)}
    with pytest.raises(ValueError, match="divisible"):
        impl(params, torch.zeros(2, 8, D), MoEConfig(6, 2, 16))
    with pytest.raises(ValueError, match="plan="):
        EP.make_moe_ep(mesh, EP.EPConfig(), bucket=4)
    with pytest.raises(ValueError, match="mode"):
        EP.make_moe_ep(mesh, EP.EPConfig(mode="ring"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_test_mesh(1, 4)
