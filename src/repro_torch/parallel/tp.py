"""Tensor and sequence parallelism across processes — the port's placement
of the reference's tp_sp mode (``repro.launch.steps.make_steps(mode=
"tp_sp")``: the params' ``ShardingRules`` specs, the residual's
``act_spec``, the heads' spec, and the collectives GSPMD puts between
them).

A :class:`TensorParallel` holds a process mesh's model group, over which the
heads, the vocabulary, the experts, the MLP's and the recurrent blocks'
channels and, with sequence parallelism, the residual's sequence are
split, and with FSDP its data column, over which the layer matrices' ``d``
is split. Each rank keeps exactly the blocks of the reference's specs:
where a block does not line up with the computation, activations or small
weights move over ``model``, never a large weight. ``launch.steps`` sets it
around a train step (``parallel.ctx.tensor_parallel_context``), and the
model reads it (``models.model``, ``models.layers``, ``models.ssm``,
``models.rglru``):

* the residual between blocks is this rank's sequence chunk of its data
  group's rows, ``[B/D, S/M, d]`` (``seq``: Megatron's sequence
  parallelism), or without it the group's rows whole, replicated over
  ``model``;
* ``enter(x)``: a block's input as the group's whole sequence (an
  all-gather over ``model``, whose transpose is a reduce-scatter);
  ``leave(y)``: a block's partial sums (a row-parallel output, the
  embedding's vocabulary blocks) back to the residual, reduce-scattered
  over the sequence or, without ``seq``, all-reduced;
* ``head_range(n)``: a rank's query heads, a contiguous block, so GQA's
  grouping holds: H / M each, or where the heads do not split (``H % M``)
  ⌈H/M⌉ on the first H mod M ranks and ⌊H/M⌋ on the rest (rank 0 the
  busiest; a rank may hold none). ``wq``/``bq``/``wo`` then arrive gathered
  whole over ``model`` (their spec blocks need not hold whole heads), and
  ``attention_params`` slices the rank's heads' columns out;
  ``kv_select``: where the kv heads do not split (``n_kv_heads % M``,
  gemma's one), ``wk``/``wv`` arrive whole, the rank computes the kv heads
  its query heads read (``kv_range``), and each query head reads its
  group's;
* ``glu_pair(h)``: the GLU's ``x @ w_in`` block (``w_in`` is gate ‖ up,
  split contiguously, so at M = 2 rank 0 holds every gate column) as the
  rank's gate block and up block, by one all-to-all (M = 2) or an
  all-gather and a slice;
* ``gather_cols(y)``: a projection's or a branch's channel blocks whole
  (the SSM's ``in_proj``, whose block cuts across z ‖ x ‖ B ‖ C ‖ dt; the
  RG-LRU's conv'd branch, which its gates read whole); ``psum(x)``: a
  statistic each rank reads for its own channels, summed over the ranks
  (the SSM's gated RMSNorm);
* ``moe(fn, h)``: the EP program (``parallel.ep``, mode tp_sp) on the
  rank's rows; without ``seq`` on the rank's chunk of the replicated
  residual, the outputs all-gathered, or, where the sequence does not
  split (a decode step's one token), on the group's rows, which every rank
  routes, as the reference's ``x_spec`` places them; ``moe_chunk`` tells
  the program which (the dropless fragment gathers the whole batch from
  either);
* ``layer(p, part)``: a layer's FSDP leaves all-gathered over ``data``
  (their grads reduce-scattered) and the small leaves the rank reads whole
  all-gathered over ``model`` (the shared kv heads' ``wk``/``wv``, the
  SSM's conv), called inside the function remat checkpoints, so the
  recompute gathers again and one layer's whole weights are live at a
  time;
* ``tokens(t)``: a batch's tokens, labels or frames over the group's whole
  sequence (``split_tokens=False``: the batch holds them whole, as a decode
  step's one token); ``vocab_max``/``vocab_sum``: the cross entropy's
  statistics over the vocabulary blocks.

Serving (``launch.steps`` on a process mesh) adds :class:`CacheBlocks`:
the cache's ``cache_spec`` blocks each rank holds, in every mode. A prefill
keeps training's placement; a decode step's residual is replicated over
``model`` (``seq=False``). The attention's kv cache holds every kv head
over the rank's block of slots, so a prefill exchanges the rank's kv heads
for its slots (one all-to-all) and a decode step gathers the new token's
query and kv heads for flash decoding over the blocks
(``parallel.flash_decode``); the SSM's conv state is gathered, the SSM's
heads and the RG-LRU's channels line up with the rank's.

A tensor replicated over ``model`` carries a partial share of its
cotangent on each rank (``parallel.comm``): each rank's heads, channels,
vocabulary block or sequence chunk adds its part, and the transposes of
the collectives sum them where a block's grad is taken. A param's grad is
so complete on each rank for its block where the spec splits it over
``model``, and a partial sum elsewhere, which ``launch.steps.reduce_grads``
adds over the model group.
"""

from __future__ import annotations

import torch

from ..parallel.sharding import (cache_blocks, cache_specs, jax_leaves,
                                  spec_axes)

# The parts of a layer's params that ``TensorParallel.layer`` places.
PARTS = ("attn", "moe", "mlp", "ssm", "rglru")


def _layer_specs(rules) -> dict:
    """(part, name) of each layer leaf -> its spec without the layer entry
    (a stacked leaf's; a hybrid tail's is unstacked and has none). Made
    once a rules object: a step that places itself when called (serving)
    then runs no op to do so."""
    if "_layer_specs" in rules.__dict__:
        return rules._layer_specs
    from ..models.model import init_params
    out = rules._layer_specs = {}
    for path, shape, stacked in jax_leaves(init_params(rules.cfg,
                                                       device="meta")):
        if len(path) < 2 or path[-2] not in PARTS:
            continue
        spec = rules.param_spec(path, shape)
        out[tuple(path[-2:])] = spec[1:] if stacked else spec
    return out


def _dims(specs: dict, axis: str) -> dict:
    """(part, name) -> the dim its spec splits over ``axis``."""
    return {k: dim for k, spec in specs.items()
            for dim, entry in enumerate(spec) if axis in spec_axes((entry,))}


class TensorParallel:
    """The tp_sp placement of ``rules`` (mode ``tp_sp``) on the process
    ``mesh``; ``seq``: sequence-parallel residual (the reference's
    ``seq_parallel``)."""

    def __init__(self, mesh, rules, seq: bool = True,
                 split_tokens: bool = True):
        cfg = rules.cfg
        if rules.mode != "tp_sp":
            raise ValueError(f"tensor parallelism is the tp_sp mode's, not "
                             f"{rules.mode}'s")
        self.comm = mesh.comm
        self.m, self.rank = self.comm.ep, self.comm.rank
        self.seq = seq
        self.split_tokens = split_tokens
        self.moe_chunk = False          # set by ``moe``
        types = set(cfg.layer_types())
        # Query heads need not split (``head_range``); these channels do.
        need = {}
        if types & {"attn", "local_attn", "rglru"}:
            need["d_ff"] = cfg.d_ff          # the MLP's channels
        if "ssm" in types:
            need["the SSM's heads"] = cfg.ssm.n_heads(cfg.d_model)
        if "rglru" in types:
            need["lru_width"] = cfg.lru_width or cfg.d_model
        for what, n in need.items():
            if n % self.m:
                raise ValueError(
                    f"{cfg.name}: {what} = {n} does not split over the "
                    f"{self.m} ranks of the model axis (the reference "
                    f"lets GSPMD place them; the port splits channel "
                    f"blocks)")
        embed = rules.param_spec(("embed",), (cfg.padded_vocab,
                                              cfg.d_model))
        self.split_vocab = embed[0] == "model"
        self.specs = _layer_specs(rules)
        self.fsdp = _dims(self.specs, "data") if rules.fsdp else {}
        self.data = mesh.axes_comm(("data",)) if self.fsdp else None
        # The leaves a rank reads whole, gathered over ``model``: the query
        # projections where the heads do not split, the kv projections
        # where the kv heads do not, the SSM's conv.
        self.uneven = cfg.n_heads % self.m != 0
        whole = [("ssm", "conv_w"), ("ssm", "conv_b")]
        if self.uneven:
            whole += [("attn", k) for k in ("wq", "bq", "wo")]
        if cfg.n_kv_heads % self.m:
            whole += [("attn", k) for k in ("wk", "wv", "bk", "bv")]
        model = _dims(self.specs, "model")
        self.whole = {k: model[k] for k in whole if k in model}

    def splits(self, part: str, name: str) -> bool:
        """Whether the model axis splits the leaf ``name`` of ``part``."""
        return "model" in spec_axes(self.specs.get((part, name), ()))

    # -- the residual --------------------------------------------------------
    def enter(self, x):
        """The residual ``x`` as the group's whole sequence."""
        return self.comm.all_gather_dim(x, 1) if self.seq else x

    def leave(self, y):
        """The rank's partial sums ``y`` [b, S, d] of the group's whole
        sequence, summed over the ranks, as the residual."""
        if self.seq:
            return self.comm.reduce_scatter_dim(y, 1)
        return self.comm.all_reduce_sum(y, partial_grads=True)

    def seq_chunk(self, x):
        """The rank's chunk of dim 1 of ``x``, which every rank holds
        whole."""
        if self.m == 1:
            return x
        c = x.shape[1] // self.m
        return x[:, self.rank * c:(self.rank + 1) * c]

    def local(self, x):
        """A tensor every rank holds whole over the group's sequence, as
        the residual: with ``seq`` the rank's chunk."""
        return self.seq_chunk(x) if self.seq else x

    def last(self, x):
        """The last position of the residual ``x`` [b, s, d] as [b, d] on
        every rank: with ``seq`` it lies in the last rank's chunk, and each
        rank's last position is all-gathered."""
        if self.seq and self.m > 1:
            return self.comm.all_gather_dim(x[:, -1:], 1)[:, -1]
        return x[:, -1]

    def whole_seq(self, x):
        """A tensor laid out as the residual [b, s, ...] over the group's
        whole sequence."""
        return self.comm.all_gather_dim(x, 1) if self.seq else x

    def vocab_whole(self, logits):
        """Logits over the rank's vocabulary block as the whole vocabulary
        (its last dim)."""
        return self.gather_cols(logits) if self.split_vocab else logits

    def own_chunk(self, x):
        """The rank's sequence chunk of the residual ``x``."""
        return x if self.seq else self.seq_chunk(x)

    def head_range(self, n: int) -> tuple:
        """[lo, hi) of the rank's block of ``n`` heads: ⌈n/M⌉ on each of
        the first ``n % M`` ranks, ⌊n/M⌋ on the others."""
        q, r = divmod(n, self.m)
        lo = self.rank * q + min(self.rank, r)
        return lo, lo + q + int(self.rank < r)

    def kv_range(self, n_heads: int, n_kv_heads: int) -> tuple:
        """[lo, hi) of the kv heads the rank's query heads read."""
        lo, hi = self.head_range(n_heads)
        g = n_heads // n_kv_heads
        return (lo // g, (hi - 1) // g + 1) if hi > lo else (lo // g,) * 2

    def kv_select(self, n_heads: int, n_kv_heads: int):
        """``None`` where the kv heads split over the ranks, else the kv
        head each of the rank's query heads reads, counted from the first
        of ``kv_range``."""
        if n_kv_heads % self.m == 0:
            return None
        lo, hi = self.head_range(n_heads)
        k_lo = self.kv_range(n_heads, n_kv_heads)[0]
        return torch.arange(lo, hi) // (n_heads // n_kv_heads) - k_lo

    def attention_params(self, p: dict, n_heads: int, n_kv_heads: int,
                         head_dim: int) -> tuple:
        """(the rank's attention params, its query heads, its kv heads,
        ``kv_select``'s indices or ``None``) from ``p`` as ``layer`` gives
        it: the spec blocks, with the leaves the rank reads whole gathered.
        Where the heads do not split, the rank's heads' columns of
        ``wq``/``bq`` and rows of ``wo`` are sliced out; where the kv heads
        do not, the columns of the kv heads it reads."""
        if self.m == 1:
            return p, n_heads, n_kv_heads, None
        lo, hi = self.head_range(n_heads)
        p = dict(p)
        if self.uneven:
            cols = slice(lo * head_dim, hi * head_dim)
            p["wq"], p["wo"] = p["wq"][:, cols], p["wo"][cols]
            if "bq" in p:
                p["bq"] = p["bq"][cols]
        sel = self.kv_select(n_heads, n_kv_heads)
        if sel is None:
            return p, hi - lo, n_kv_heads // self.m, None
        k_lo, k_hi = self.kv_range(n_heads, n_kv_heads)
        cols = slice(k_lo * head_dim, k_hi * head_dim)
        for k in ("wk", "wv"):
            p[k] = p[k][:, cols]
        for k in ("bk", "bv"):
            if k in p:
                p[k] = p[k][cols]
        return p, hi - lo, k_hi - k_lo, sel

    def moe(self, fn, h):
        """``fn`` (the EP program) on the rank's rows of ``h``: without
        ``seq`` its chunk, the outputs all-gathered over the sequence; where
        the sequence does not split, the group's rows whole.

        While ``fn`` runs, ``moe_chunk`` says which: ``True`` where its
        rows are the rank's sequence chunk (the model rank's block of the
        group's sequence), ``False`` where they are the group's rows whole,
        which every rank of the group holds. A program that places its
        rows in the whole batch (the dropless fragment on a process mesh,
        ``launch.dropless``) reads it."""
        S = h.shape[1]
        whole = self.m == 1 or (not self.seq and (S == 1 or S % self.m))
        self.moe_chunk = not whole
        if whole or self.seq:
            return fn(h)
        return self.comm.all_gather_dim(fn(self.own_chunk(h)), 1)

    # -- channel blocks ------------------------------------------------------
    def glu_pair(self, h):
        """``h`` [b, S, 2F/M], the rank's contiguous block of the GLU's
        gate ‖ up columns, as its gate block r ‖ up block r (F/M each), the
        rows of its ``w_down`` block. At M = 2 rank 0 holds both gate
        blocks and rank 1 both up blocks: one all-to-all swaps a block each
        way (its transpose is the inverse all-to-all). Otherwise the blocks
        are all-gathered and the rank's two sliced out."""
        m = self.m
        if m == 1:
            return h
        f = h.shape[-1] // 2
        if m == 2:
            got = self.comm.all_to_all([torch.stack([h[..., :f],
                                                     h[..., f:]])])[0]
            return torch.cat([got[0], got[1]], dim=-1)
        whole = self.gather_cols(h)
        F = whole.shape[-1] // 2
        r = self.rank
        return torch.cat([whole[..., r * f:(r + 1) * f],
                          whole[..., F + r * f:F + (r + 1) * f]], dim=-1)

    def gather_cols(self, y):
        """Every rank's channel block of ``y`` (its last dim), whole; the
        transpose reduce-scatters the partial cotangents."""
        if self.m == 1:
            return y
        return self.comm.all_gather_dim(y, y.dim() - 1)

    def channels(self, n: int) -> tuple:
        """[lo, hi) of the rank's block of ``n`` channels."""
        c = n // self.m
        return self.rank * c, (self.rank + 1) * c

    def psum(self, x):
        """The sum over the ranks of ``x``, a statistic each rank reads for
        its own channels (each holds a partial share of its cotangent)."""
        if self.m == 1:
            return x
        return self.comm.all_reduce_sum(x, partial_grads=True)

    # -- params --------------------------------------------------------------
    def layer(self, p: dict, part: str) -> dict:
        """``p`` (a layer's dict of ``part``) with each leaf FSDP splits
        gathered whole over ``data`` and each leaf the rank reads whole
        gathered over ``model``."""
        out = {}
        for k, v in p.items():
            if (part, k) in self.fsdp:
                v = self.data.all_gather_dim(v, self.fsdp[(part, k)])
            if (part, k) in self.whole:
                v = self.comm.all_gather_dim(v, self.whole[(part, k)])
            out[k] = v
        return out

    # -- tokens and the vocabulary -------------------------------------------
    def tokens(self, t):
        """A batch's tokens, labels or frames [b, S/M, ...] over the
        group's whole sequence (held whole already without
        ``split_tokens``)."""
        return self.comm.all_gather_dim(t, 1) if self.split_tokens else t

    def vocab_lo(self, block: int) -> int:
        """The first vocabulary index of this rank's block of ``block``
        rows (``split_vocab``)."""
        return self.rank * block

    def vocab_max(self, x):
        """The elementwise max of every rank's ``x`` (no grad)."""
        if self.m == 1:
            return x
        return self.comm.pmax([x.detach().contiguous()])[0]

    def vocab_sum(self, x):
        """The sum of every rank's ``x``, a statistic every rank consumes
        alike (its backward is the identity)."""
        return self.comm.all_reduce_sum(x, partial_grads=False)


class CacheBlocks:
    """A serving step's cache on a process mesh: this rank's blocks of
    ``init_cache(cfg, batch, max_len)`` by the reference's ``cache_spec``
    (``sharding.cache_specs``, which refuses a spec naming an axis twice),
    in every mode (``batch`` is the whole batch's rows). Rows over the data
    axes are the rank's already; every other split is over ``model``, and
    a dim is split exactly where the model axis divides it, as the specs'
    rule has it: k/v over the slots, the SSM state over heads, the conv
    states and the RG-LRU's ``h`` over channels."""

    def __init__(self, mesh, rules, batch: int, max_len: int):
        from ..models.model import init_cache
        self.mesh, self.rules, self.cfg = mesh, rules, rules.cfg
        self.comm = mesh.comm
        self.m, self.rank = self.comm.ep, self.comm.rank
        self.batch, self.max_len = batch, max_len
        # A spec that names an axis twice raises here.
        cache_specs(rules, init_cache(rules.cfg, batch, max_len,
                                      device="meta"))

    def alloc(self, device):
        """The rank's empty blocks on ``device``
        (``sharding.cache_blocks``)."""
        return cache_blocks(self.rules, self.batch, self.max_len, self.mesh,
                            device)

    def slots(self, btype: str) -> int:
        """An attention layer's slots in the whole cache: a ``local_attn``
        ring's min(max_len, window), else ``max_len``."""
        if btype == "local_attn":
            return min(self.max_len, self.cfg.sliding_window or self.max_len)
        return self.max_len

    def splits(self, n: int) -> bool:
        """Whether the model axis splits a cache dim of ``n`` (whole)."""
        return self.m > 1 and n % self.m == 0

    def block(self, t, dim: int):
        """The rank's block along ``dim`` of ``t``, which every rank holds
        whole."""
        n = t.shape[dim]
        if not self.splits(n):
            return t
        c = n // self.m
        return t.narrow(dim, self.rank * c, c)

    def whole(self, t, dim: int, n: int):
        """The rank's block ``t`` of a dim of ``n`` as the whole, gathered
        over ``model`` where it splits."""
        return self.comm.all_gather_dim(t, dim) if self.splits(n) else t

    def exchange(self, content):
        """``content`` [b, W, k, hd], the rank's k kv heads over every slot
        of a cache of W, as every rank's heads over this rank's block of
        slots [b, W/M, M·k, hd]: one all-to-all over ``model`` (where W does
        not split, an all-gather of the heads). Every rank sends and
        receives, whatever heads it holds."""
        if not self.splits(content.shape[1]):
            return self.comm.all_gather_dim(content, 2)
        b, W, k, hd = content.shape
        send = content.reshape(b, self.m, W // self.m, k, hd).transpose(0, 1)
        got = self.comm.all_to_all([send.contiguous()])[0]
        return got.permute(1, 2, 0, 3, 4).reshape(b, W // self.m,
                                                  self.m * k, hd)
