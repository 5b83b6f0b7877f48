"""The port's ``ShardingRules`` against the reference's: for every arch at
its smoke and its full shapes (the JAX params by ``jax.eval_shape``, the
port's on the meta device), on meshes 2x4, 1x4 and 2x2x2, in the three
modes, with FSDP on and off, every leaf's param and optimizer-state spec,
and the batch, activation and cache specs, equal to the reference's. The
port's per-layer tree, seen through the JAX layout, has the reference's
leaves and shapes. Then ``local_block``/``assemble`` round trips and the
block order of a tuple of axes (the first axis major)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.parallel.sharding import ShardingRules as JRules  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import get_smoke_config as tget_smoke  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402

MESHES = {"2x4": {"data": 2, "model": 4}, "1x4": {"data": 1, "model": 4},
          "2x2x2": {"pod": 2, "data": 2, "model": 2},
          # The reference's production meshes, at full size alone.
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
PRODUCTION = ("16x16", "2x16x16")
MODES = ("tp_sp", "zero1", "ep_dp")
SIZES = ("smoke", "full")
SIZE_MESHES = [(size, mesh) for size in SIZES for mesh in MESHES
               if size == "full" or mesh not in PRODUCTION]


class _FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _canon(spec) -> tuple:
    """A PartitionSpec as the port writes it: a one-name tuple is the
    name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _cfgs(arch, size):
    if size == "smoke":
        return jget_smoke(arch), tget_smoke(arch)
    return jget(arch), tget(arch)


@functools.lru_cache(maxsize=None)
def _jax_leaves(arch, size):
    """(path, shape) of each leaf of the reference's params and cache."""
    jcfg, _ = _cfgs(arch, size)
    shapes = jax.eval_shape(
        lambda: JM.init_params(jcfg, jax.random.PRNGKey(0)))
    params = [(tuple(path), tuple(leaf.shape)) for path, leaf in
              jax.tree_util.tree_flatten_with_path(shapes)[0]]
    cache = []
    if jcfg.family != "audio":
        cshapes = jax.eval_shape(lambda: JM.init_cache(jcfg, 8, 64))
        cache = [(tuple(path), tuple(leaf.shape)) for path, leaf in
                 jax.tree_util.tree_flatten_with_path(cshapes)[0]]
    return params, cache


def _key(k):
    return getattr(k, "key", getattr(k, "idx", k))


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("size,mesh", SIZE_MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference(arch, size, mesh, mode, fsdp):
    jcfg, tcfg = _cfgs(arch, size)
    fake = _FakeMesh(MESHES[mesh])
    ref = JRules(jcfg, fake, fsdp=fsdp, mode=mode)
    port = S.ShardingRules(tcfg, fake, fsdp=fsdp, mode=mode)
    params, cache = _jax_leaves(arch, size)
    for path, shape in params:
        where = ("/".join(str(_key(k)) for k in path), shape)
        assert port.param_spec(path, shape) == _canon(
            ref.param_spec(path, shape)), where
        assert port.opt_state_spec(path, shape) == _canon(
            ref.opt_state_spec(path, shape)), where
    for path, shape in cache:
        assert port.cache_spec(path, shape) == _canon(
            ref.cache_spec(path, shape)), path
    for B in (1, 2, 6, 8, 256):
        batch = {"tokens": (B, 4096), "labels": (B, 4096)}
        if jcfg.family == "audio":
            batch = {"features": (B, 4096, jcfg.feat_in), "labels": (B,
                                                                     4096)}
        if jcfg.family == "vlm":
            batch["patches"] = (B, 256, 3 * 14 * 14)
        jb = {k: jax.ShapeDtypeStruct(v, jnp.float32)
              for k, v in batch.items()}
        assert port.batch_spec(batch) == {
            k: _canon(v) for k, v in ref.batch_spec(jb).items()}, B
        assert port.act_spec(B) == _canon(ref.act_spec(B)), B
    assert port.fsdp == ref.fsdp


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_port_tree_through_the_jax_layout(arch, size):
    """The port's per-layer params on meta, seen as the JAX layout's
    leaves, are the reference's leaves in flatten order; each per-layer
    spec is its leaf's spec without the layer entry."""
    _, tcfg = _cfgs(arch, size)
    meta = TM.init_params(tcfg, device="meta")
    params, _ = _jax_leaves(arch, size)
    want = [(tuple(str(_key(k)) for k in p), s) for p, s in params]
    got, seen = [], set()
    for path, shape, stacked in S.jax_leaves(meta):
        key = (tuple(str(k) for k in path), shape)
        if key not in seen:
            seen.add(key)
            got.append(key)
    assert got == want
    rules = S.ShardingRules(tcfg, _FakeMesh(MESHES["2x2x2"]), mode="ep_dp")
    leaves = S.jax_leaves(meta)
    for (path, shape, stacked), spec in zip(
            leaves, S.opt_state_specs(rules, meta), strict=True):
        assert spec == rules.opt_state_spec(path, shape)[int(stacked):]


SPECS = [(("data", "model"), None), ("model", "data"),
         (None, ("pod", "data", "model")), (("model", "data"), None),
         ("pod", ("data", "model")), (None, None)]


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_local_block_and_assemble_round_trip(spec):
    mesh = {"pod": 2, "data": 2, "model": 2}
    t = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    n = int(np.prod(list(mesh.values())))
    blocks = [S.local_block(t, spec, mesh, S.rank_coords(mesh, r)).clone()
              for r in range(n)]
    assert all(tuple(b.shape) == S.block_shape(t.shape, spec, mesh)
               for b in blocks)
    assert torch.equal(S.assemble(blocks, spec, mesh), t)


def test_block_order_of_a_tuple_of_axes():
    """``("data", "model")`` on a 2x2 mesh: rank (d, m) holds block
    d * 2 + m, data the major axis, as the reference's PartitionSpec lays
    a tuple of axes out (and ranks count model fastest)."""
    mesh = {"data": 2, "model": 2}
    t = torch.arange(8)
    for r in range(4):
        c = S.rank_coords(mesh, r)
        assert c == {"data": r // 2, "model": r % 2}
        blk = S.local_block(t, (("data", "model"),), mesh, c)
        assert blk.tolist() == [2 * (c["data"] * 2 + c["model"]),
                                2 * (c["data"] * 2 + c["model"]) + 1]
        rev = S.local_block(t, (("model", "data"),), mesh, c)
        assert rev.tolist()[0] == 2 * (c["model"] * 2 + c["data"])
