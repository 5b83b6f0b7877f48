"""Per-architecture sharding rules — counterpart of
``repro.parallel.sharding``: param, optimizer-state, batch, activation and
cache specs over the axes of a mesh.

A spec is a tuple with one entry per dim: ``None`` (replicated), an axis
name, or a tuple of axis names, the first the major one (the reference's
``PartitionSpec``; a one-name tuple is written as the name, as
``PartitionSpec`` canonicalizes it). The three modes are the reference's:

* ``tp_sp`` — tensor parallel over ``model`` + sequence-parallel
  activations (FSDP over ``data`` for the large archs);
* ``zero1`` — pure data parallelism over every axis: params replicated,
  optimizer state sharded (ZeRO-1), batch over (pod, data, model);
* ``ep_dp`` — zero1 for the dense trunk, the experts sharded over
  ``model`` (the paper's dp × ep production layout).

The rules key on the reference's param paths and stacked ``[L, ...]``
leaves (``"blocks"``/``"super"``). The port keeps one tensor per layer, so
:func:`param_specs` and :func:`opt_state_specs` compute each spec on the
leaf of the JAX layout that ``convert.JaxTrainLayout`` maps the port's
tree to, and give a per-layer tensor that spec without its layer entry.

:func:`local_block` is the block of a tensor that the process at
``coords`` holds, :func:`assemble` its inverse over every rank's block.

A serving cache is the port's tree (``models.model.init_cache``: one dict
a layer, or a hybrid's ``{"super", "tail"}``) where the reference stacks
``[L, ...]`` leaves: :func:`cache_specs` gives each leaf the reference's
``cache_spec`` without its layer entry and refuses a spec that names one
axis twice, as the reference's ``PartitionSpec`` raises
``DuplicateSpecError`` (zero1 or ep_dp with rows split over ``model`` and a
sequence the model axis splits too); :func:`cache_blocks` makes a rank's
empty blocks and :func:`own_cache` cuts them from a whole cache.
"""

from __future__ import annotations

import math

import torch

FSDP_THRESHOLD = 10e9
MODES = ("tp_sp", "zero1", "ep_dp")
# The port's layer trees: stacked over layers in JAX (``blocks``), per
# pattern position stacked over super-blocks (``super``), or unstacked
# (``tail``).
_STACKED = ("blocks", "super")


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _entry(axes):
    """A dim's entry from a list of axis names: ``None``, the name, or the
    tuple of names."""
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _key(k):
    return getattr(k, "key", getattr(k, "idx", k))


def dp_axes(mesh) -> tuple:
    """The pure data-parallel axes of a mesh (pod is outer DP)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


class ShardingRules:
    """The reference's rules over ``mesh`` (anything with ``shape``, a dict
    of axis sizes, and ``axis_names``)."""

    def __init__(self, cfg, mesh, fsdp: bool | None = None,
                 mode: str = "tp_sp"):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r}: one of {MODES}")
        self.cfg = cfg
        self.mesh = mesh
        self.mode = mode
        self.dp = dp_axes(mesh)
        self.model_n = mesh.shape.get("model", 1)
        self.fsdp = (cfg.param_count() > FSDP_THRESHOLD
                     if fsdp is None else fsdp)
        self.data_n = mesh.shape.get("data", 1)
        self.all_axes = tuple(mesh.axis_names)

    # -- helpers -------------------------------------------------------------
    def _m(self, dim: int):
        """'model' if divisible else None."""
        return "model" if _div(dim, self.model_n) else None

    def _f(self, dim: int):
        """FSDP ('data') if enabled and divisible else None."""
        return "data" if (self.fsdp and _div(dim, self.data_n)) else None

    # -- parameter rules -----------------------------------------------------
    def param_spec(self, path, shape) -> tuple:
        keys = [_key(k) for k in path]
        name = keys[-1] if keys else ""
        stacked = any(k in _STACKED for k in keys)
        lead = (None,) if stacked else ()
        body_shape = tuple(shape)[len(lead):]
        if self.mode in ("zero1", "ep_dp"):
            body = self._param_spec_dp(name, body_shape)
        else:
            body = self._param_spec_body(name, body_shape)
        return lead + body

    def _param_spec_dp(self, name: str, s: tuple) -> tuple:
        """DP modes: replicate everything except MoE experts in ep_dp."""
        if (self.mode == "ep_dp" and name in ("w_in", "w_down")
                and len(s) == 3):
            return (self._m(s[0]), None, None)   # experts over 'model'
        return (None,) * len(s)

    def opt_state_spec(self, path, shape) -> tuple:
        """ZeRO-1: moments/master sharded over as many axes as divide."""
        if self.mode not in ("zero1", "ep_dp"):
            return self.param_spec(path, shape)
        base = list(self.param_spec(path, shape))
        used = {a for a in base if a}
        free = [a for a in self.all_axes if a not in used]
        # shard the largest unsharded dim over the free axes (greedy).
        dims = sorted(range(len(shape)), key=lambda i: -shape[i])
        for i in dims:
            if base[i] is not None:
                continue
            take = []
            rem = shape[i]
            for a in free:
                n = self.mesh.shape[a]
                if rem % n == 0:
                    take.append(a)
                    rem //= n
            if take:
                base[i] = _entry(take)
                break
        return tuple(base)

    def _param_spec_body(self, name: str, s: tuple) -> tuple:
        cfg = self.cfg
        if name == "embed":
            return (self._m(s[0]), None)
        if name == "unembed":
            return (None, self._m(s[1]))
        if name in ("wq", "wk", "wv"):
            return (self._f(s[0]), self._m(s[1]))
        if name == "wo":
            return (self._m(s[0]), self._f(s[1]))
        if name in ("bq", "bk", "bv"):
            return (self._m(s[0]),)
        if name == "w_in" and len(s) == 3:    # MoE experts [E, d, 2f]
            return (self._m(s[0]), self._f(s[1]), None)
        if name == "w_down" and len(s) == 3:  # [E, f, d]
            return (self._m(s[0]), None, self._f(s[2]))
        if name == "w_in":
            return (self._f(s[0]), self._m(s[1]))
        if name == "w_down":
            return (self._m(s[0]), self._f(s[1]))
        if name == "router":
            return (None, None)
        if name == "in_proj":                 # ssm [d, zxbcdt]
            return (self._f(s[0]), self._m(s[1]))
        if name in ("conv_w", "conv_b"):
            return (None,) * (len(s) - 1) + (self._m(s[-1]),)
        if name == "out_proj":
            return (self._m(s[0]), self._f(s[1]))
        if name == "norm_w" and len(s) == 1 and s[0] != cfg.d_model:
            return (self._m(s[0]),)
        if name in ("in_x", "in_y"):          # rglru [d, w]
            return (self._f(s[0]), self._m(s[1]))
        if name in ("gate_a", "gate_x"):      # [w, w]
            return (None, self._m(s[1]))
        if name in ("gate_a_b", "gate_x_b", "lam"):
            return (self._m(s[0]),)
        if name == "out" and len(s) == 2:     # rglru out [w, d]
            return (self._m(s[0]), self._f(s[1]))
        if name == "feat_proj":
            return (None, None)
        # norms, scalars, A_log, D, dt_bias, ln*: replicate
        return (None,) * len(s)

    # -- batch rules ---------------------------------------------------------
    def _batch_axis(self, B: int):
        """Shard batch over as many (mode-appropriate) axes as divide it."""
        pool = (self.all_axes if self.mode in ("zero1", "ep_dp")
                else self.dp)
        axes = []
        rem = B
        for a in pool:
            n = self.mesh.shape[a]
            if rem % n == 0:
                axes.append(a)
                rem //= n
        return _entry(axes)

    def batch_spec(self, batch_shapes: dict) -> dict:
        """``{name: spec}`` for a batch given as ``{name: shape}`` (or
        anything with ``.shape``)."""
        out = {}
        for k, v in batch_shapes.items():
            shape = tuple(getattr(v, "shape", v))
            ba = self._batch_axis(shape[0])
            if k in ("tokens", "labels"):
                seq_m = ("model" if self.mode == "tp_sp"
                         and len(shape) > 1
                         and _div(shape[1], self.model_n)
                         and shape[1] > 1 else None)
                out[k] = (ba, seq_m) if len(shape) == 2 else (ba,)
            elif k == "features":
                seq_m = (self._m(shape[1]) if self.mode == "tp_sp"
                         else None)
                out[k] = (ba, seq_m, None)
            elif k == "patches":
                out[k] = (ba, None, None)
            else:
                out[k] = (ba,) + (None,) * (len(shape) - 1)
        return out

    # -- activation constraint (sequence parallelism) ------------------------
    def act_spec(self, B: int) -> tuple:
        return (self._batch_axis(B), "model", None)

    # -- cache rules ---------------------------------------------------------
    def cache_spec(self, path, shape) -> tuple:
        keys = [str(_key(k)) for k in path]
        name = keys[-1] if keys else ""
        shape = tuple(shape)
        if name in ("k", "v"):
            # [L, B, S, K, hd] (stacked) or [B, S, K, hd]
            lead = (None,) if len(shape) == 5 else ()
            B, S = shape[len(lead)], shape[len(lead) + 1]
            return lead + (self._batch_axis(B),
                           "model" if _div(S, self.model_n) else None,
                           None, None)
        if name == "len":
            return (None,) * len(shape)
        if name == "ssm":
            lead = (None,) if len(shape) == 5 else ()
            B, H = shape[len(lead)], shape[len(lead) + 1]
            return lead + (self._batch_axis(B), self._m(H), None, None)
        if name == "conv":
            lead = (None,) if len(shape) == 4 else ()
            B = shape[len(lead)]
            C = shape[-1]
            return lead + (self._batch_axis(B), None, self._m(C))
        if name == "h":
            lead = (None,) if len(shape) == 3 else ()
            B, W = shape[len(lead)], shape[len(lead) + 1]
            return lead + (self._batch_axis(B), self._m(W))
        return (None,) * len(shape)


# -- blocks of a mesh ---------------------------------------------------------


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec) -> tuple:
    """Every axis a spec shards over, in the order its entries name them."""
    return tuple(a for e in spec for a in _axes(e))


def rank_coords(mesh_shape: dict, rank: int) -> dict:
    """The coords of global ``rank`` on a mesh of ``mesh_shape``: row-major
    over the axes, the last (``model``) fastest, as the reference's device
    mesh numbers its devices."""
    coords = {}
    for a in reversed(tuple(mesh_shape)):
        rank, coords[a] = divmod(rank, mesh_shape[a])
    return {a: coords[a] for a in mesh_shape}


def _block_index(entry, mesh_shape: dict, coords: dict) -> tuple:
    """(number of blocks along a dim, this coords' block), the entry's
    first axis the major one."""
    n, idx = 1, 0
    for a in _axes(entry):
        n, idx = n * mesh_shape[a], idx * mesh_shape[a] + coords[a]
    return n, idx


def local_block(t: torch.Tensor, spec, mesh, coords: dict) -> torch.Tensor:
    """The block of ``t`` (a view) that the rank at ``coords`` holds under
    ``spec`` over ``mesh`` (a mesh, or its shape dict)."""
    shape = getattr(mesh, "shape", mesh)
    if len(spec) != t.dim():
        raise ValueError(f"spec {spec} has {len(spec)} entries for a "
                         f"{t.dim()}-d tensor")
    for dim, entry in enumerate(spec):
        n, idx = _block_index(entry, shape, coords)
        if n > 1:
            if t.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                                 f"split into {n} blocks ({spec})")
            size = t.shape[dim] // n
            t = t.narrow(dim, idx * size, size)
    return t


def block_shape(shape, spec, mesh) -> tuple:
    """The shape of every rank's block of a ``shape`` tensor."""
    mshape = getattr(mesh, "shape", mesh)
    return tuple(s // math.prod(mshape[a] for a in _axes(e))
                 for s, e in zip(shape, spec))


def assemble(blocks, spec, mesh) -> torch.Tensor:
    """The whole tensor from ``blocks``, every rank's block in global rank
    order (:func:`rank_coords`); ranks that hold the same block must hold
    the same values, and the first one's is kept."""
    mshape = getattr(mesh, "shape", mesh)
    b0 = blocks[0]
    full = tuple(s * math.prod(mshape[a] for a in _axes(e))
                 for s, e in zip(b0.shape, spec))
    out = torch.empty(full, dtype=b0.dtype, device=b0.device)
    seen = set()
    for rank, blk in enumerate(blocks):
        coords = rank_coords(mshape, rank)
        where = tuple(_block_index(e, mshape, coords)[1] for e in spec)
        if where in seen:
            continue
        seen.add(where)
        local_block(out, spec, mshape, coords).copy_(blk)
    return out


# -- the port's param tree ----------------------------------------------------


def jax_leaves(params) -> list:
    """``(jax_path, jax_shape, stacked)`` of each leaf of the port's
    ``params`` tree, in ``adamw.tree_leaves`` order: the path and shape of
    the leaf of the JAX layout (``convert.JaxTrainLayout``) it belongs to,
    and whether that leaf stacks the port's per-layer tensors on a leading
    dim."""
    out = []

    def walk(tree, jpath, lead):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], jpath + (k,), lead)
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, jpath + (i,), lead)
        else:
            shape = tuple(tree.shape)
            out.append((jpath, (lead,) + shape if lead else shape,
                        bool(lead)))

    for k in sorted(params):
        v = params[k]
        if k == "blocks":
            for layer in v:
                walk(layer, (k,), len(v))
        elif k == "super":
            for pos, layers in enumerate(v):
                for layer in layers:
                    walk(layer, (k, pos), len(layers))
        else:
            walk(v, (k,), 0)
    return out


def _whole_leaves(rules: ShardingRules, params) -> list:
    """``jax_leaves`` of the whole tree of which ``params`` are the blocks a
    rank of a process mesh holds: the tree of ``rules.cfg``, on the meta
    device (once a rules object)."""
    whole = rules.__dict__.get("_whole_leaves")
    if whole is None:
        from ..models.model import init_params
        whole = jax_leaves(init_params(rules.cfg, device="meta"))
        rules._whole_leaves = whole
    own = jax_leaves(params)
    if [p for p, _, _ in own] != [p for p, _, _ in whole]:
        raise ValueError(f"these params are not blocks of {rules.cfg.name}'s "
                         f"tree")
    return whole


def _port_specs(rules, params, fn, own) -> list:
    specs = []
    leaves = _whole_leaves(rules, params) if own else jax_leaves(params)
    for path, shape, stacked in leaves:
        spec = fn(path, shape)
        if stacked:
            if spec[0] is not None:
                raise ValueError(
                    f"{'/'.join(map(str, path))} {shape}: the spec {spec} "
                    f"shards the layer dim, and the port holds one tensor "
                    f"a layer")
            spec = spec[1:]
        specs.append(spec)
    return specs


def param_specs(rules: ShardingRules, params, own: bool = False) -> list:
    """Each port leaf's param spec, in ``adamw.tree_leaves`` order.
    ``own``: ``params`` are the blocks a rank of a process mesh holds (its
    experts in ep_dp, its block of every split leaf in tp_sp), not the whole
    tree; the specs are those of the whole leaves of ``rules.cfg``."""
    return _port_specs(rules, params, rules.param_spec, own)


def opt_state_specs(rules: ShardingRules, params, own: bool = False) -> list:
    """Each port leaf's optimizer-state spec, in ``adamw.tree_leaves``
    order (``own`` as in :func:`param_specs`)."""
    return _port_specs(rules, params, rules.opt_state_spec, own)


def relative_spec(spec, within) -> tuple:
    """``spec`` for a tensor that is already the block of ``within``: the
    axes ``within`` names are left out."""
    return tuple(None if w is not None else e for e, w in zip(spec, within))


def batch_block(rules: ShardingRules, batch: dict, mesh) -> dict:
    """This rank's block of a whole ``batch`` dict on a process mesh: each
    entry's block by ``rules.batch_spec`` (``tokens``/``labels`` and audio
    ``features`` split over the sequence in tp_sp, a vlm's ``patches``
    whole over ``model``)."""
    specs = rules.batch_spec(batch)
    return {k: local_block(v, specs[k], mesh, mesh.coords)
            for k, v in batch.items()}


def own_params(rules: ShardingRules, params, mesh):
    """This rank's params of the whole tree ``params`` on a process mesh:
    each leaf split by its param spec (ep_dp's experts; in tp_sp the
    model's heads, vocabulary and experts, and with FSDP the ``data``
    split) replaced by a copy of the rank's block, the others kept as they
    are."""
    specs = iter(param_specs(rules, params))

    def own(tree):
        if isinstance(tree, dict):
            return {k: own(tree[k]) for k in sorted(tree)}
        if isinstance(tree, (list, tuple)):
            return type(tree)(own(v) for v in tree)
        spec = next(specs)
        if not spec_axes(spec):
            return tree
        return local_block(tree, spec, mesh, mesh.coords).clone()
    return own(params)


# -- the serving cache -------------------------------------------------------


def _cache_map(fn, *trees):
    """``fn(name, jax_shape, stacked, *leaves)`` over the leaves of caches
    of one tree (a per-layer list of dicts, or a hybrid's ``{"super",
    "tail"}``): the same tree of its results. ``jax_shape`` is the shape of
    the reference's leaf (``[L, ...]``, a hybrid position's ``[n_super,
    ...]``; a tail layer's unstacked)."""
    def layer(ds, lead):
        return {k: fn(k, ((lead,) if lead else ()) + tuple(ds[0][k].shape),
                      bool(lead), *(d[k] for d in ds)) for k in ds[0]}
    first = trees[0]
    if isinstance(first, dict):
        return {"super": tuple(
                    [layer([t["super"][pos][g] for t in trees], len(layers))
                     for g in range(len(layers))]
                    for pos, layers in enumerate(first["super"])),
                "tail": [layer([t["tail"][i] for t in trees], 0)
                         for i in range(len(first["tail"]))]}
    return [layer([t[i] for t in trees], len(first))
            for i in range(len(first))]


def cache_specs(rules: ShardingRules, cache):
    """The tree of ``cache``'s specs (``rules.cache_spec`` of the
    reference's stacked leaf, its layer entry dropped). A spec that names an
    axis twice raises ``ValueError``."""
    def spec(name, shape, stacked, _leaf):
        s = rules.cache_spec((name,), shape)
        axes = spec_axes(s)
        if len(set(axes)) != len(axes):
            raise ValueError(
                f"cache leaf {name!r} {shape}: the spec {s} names an axis "
                f"twice (rows and another dim both split over it), which "
                f"the reference's PartitionSpec refuses too "
                f"(DuplicateSpecError)")
        return s[1:] if stacked else s
    return _cache_map(spec, cache)


def cache_blocks(rules: ShardingRules, batch: int, max_len: int, mesh,
                 device):
    """A process's empty serving cache on a process mesh: zeros of its
    ``cache_specs`` blocks of ``init_cache(rules.cfg, batch, max_len)``
    (``batch`` the whole batch's rows) on ``device`` (``"meta"``: shapes
    and dtypes alone)."""
    from ..models.model import init_cache
    whole = init_cache(rules.cfg, batch, max_len, device="meta")
    return _cache_map(
        lambda _n, _s, _st, leaf, spec: torch.zeros(
            block_shape(leaf.shape, spec, mesh), dtype=leaf.dtype,
            device=device),
        whole, cache_specs(rules, whole))


def own_cache(rules: ShardingRules, cache, mesh):
    """The rank at ``mesh.coords``'s blocks of a whole ``cache``, copies."""
    return _cache_map(
        lambda _n, _s, _st, leaf, spec: local_block(
            leaf, spec, mesh, mesh.coords).clone(),
        cache, cache_specs(rules, cache))
