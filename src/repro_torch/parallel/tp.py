"""Tensor and sequence parallelism across processes — the port's placement
of the reference's tp_sp mode (``repro.launch.steps.make_steps(mode=
"tp_sp")``: the params' ``ShardingRules`` specs, the residual's
``act_spec``, the heads' spec, and the collectives GSPMD puts between
them).

A :class:`TensorParallel` holds a process mesh's model group, over which the
heads, the vocabulary, the experts and, with sequence parallelism, the
residual's sequence are split, and with FSDP its data column, over which
the attention and expert matrices' ``d`` is split. ``launch.steps`` sets it
around a train step (``parallel.ctx.tensor_parallel_context``), and the
model reads it (``models.model``, ``models.layers.attention``):

* the residual between blocks is this rank's sequence chunk of its data
  group's rows, ``[B/D, S/M, d]`` (``seq``: Megatron's sequence
  parallelism), or without it the group's rows whole, replicated over
  ``model``;
* ``enter(x)``: a block's input as the group's whole sequence (an
  all-gather over ``model``, whose transpose is a reduce-scatter);
  ``leave(y)``: a block's partial sums (the row-parallel ``wo``, the
  embedding's vocabulary blocks) back to the residual, reduce-scattered
  over the sequence or, without ``seq``, all-reduced;
* ``heads(n)``: a rank's heads, a contiguous block, so GQA's grouping holds;
* ``moe(fn, h)``: the EP program (``parallel.ep``, mode tp_sp) on the
  rank's rows; without ``seq`` on the rank's chunk of the replicated
  residual, the outputs all-gathered;
* ``layer(p, part)``: a layer's FSDP leaves all-gathered over ``data``
  (their grads reduce-scattered), called inside the function remat
  checkpoints, so the recompute gathers again and one layer's whole
  weights are live at a time;
* ``tokens(t)``: a batch's tokens or labels over the group's whole
  sequence; ``vocab_max``/``vocab_sum``: the cross entropy's statistics
  over the vocabulary blocks.

A tensor replicated over ``model`` carries a partial share of its
cotangent on each rank (``parallel.comm``): each rank's heads, vocabulary
block or sequence chunk adds its part, and the transposes of the
collectives sum them where a block's grad is taken. A param's grad is so
complete on each rank for its block where the spec splits it over
``model``, and a partial sum elsewhere, which ``launch.steps.reduce_grads``
adds over the model group.
"""

from __future__ import annotations

from ..parallel.sharding import jax_leaves, spec_axes


def _fsdp_dims(rules) -> dict:
    """(part, name) of each layer leaf FSDP splits -> the dim it splits
    over ``data`` (``attn``'s projections, ``moe``'s experts)."""
    if not rules.fsdp:
        return {}
    from ..models.model import init_params
    out = {}
    for path, shape, stacked in jax_leaves(init_params(rules.cfg,
                                                       device="meta")):
        if not stacked:
            continue
        spec = rules.param_spec(path, shape)[1:]
        for dim, entry in enumerate(spec):
            if "data" in spec_axes((entry,)):
                out[tuple(path[-2:])] = dim
    return out


class TensorParallel:
    """The tp_sp placement of ``rules`` (mode ``tp_sp``) on the process
    ``mesh``; ``seq``: sequence-parallel residual (the reference's
    ``seq_parallel``)."""

    def __init__(self, mesh, rules, seq: bool = True):
        cfg = rules.cfg
        if rules.mode != "tp_sp":
            raise ValueError(f"tensor parallelism is the tp_sp mode's, not "
                             f"{rules.mode}'s")
        self.comm = mesh.comm
        self.m, self.rank = self.comm.ep, self.comm.rank
        self.seq = seq
        for what, n in (("n_heads", cfg.n_heads),
                        ("n_kv_heads", cfg.n_kv_heads)):
            if n % self.m:
                raise ValueError(
                    f"{cfg.name}: {what} = {n} does not split over the "
                    f"{self.m} ranks of the model axis (the reference "
                    f"lets GSPMD place such heads; the port splits whole "
                    f"heads)")
        embed = rules.param_spec(("embed",), (cfg.padded_vocab,
                                              cfg.d_model))
        self.split_vocab = embed[0] == "model"
        self.fsdp = _fsdp_dims(rules)
        self.data = mesh.axes_comm(("data",)) if self.fsdp else None

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

    def own_chunk(self, x):
        """The rank's sequence chunk of the residual ``x``."""
        if self.seq or self.m == 1:
            return x
        c = x.shape[1] // self.m
        return x[:, self.rank * c:(self.rank + 1) * c]

    def heads(self, n: int) -> int:
        return n // self.m

    def moe(self, fn, h):
        """``fn`` (the EP program) on the rank's rows of ``h``: without
        ``seq`` its chunk, the outputs all-gathered over the sequence."""
        if self.seq or self.m == 1:
            return fn(h)
        return self.comm.all_gather_dim(fn(self.own_chunk(h)), 1)

    # -- params --------------------------------------------------------------
    def layer(self, p: dict, part: str) -> dict:
        """``p`` (a layer's ``attn`` or ``moe`` dict) with each leaf FSDP
        splits gathered whole over ``data``."""
        if not self.fsdp:
            return p
        return {k: (self.data.all_gather_dim(v, self.fsdp[(part, k)])
                    if (part, k) in self.fsdp else v) for k, v in p.items()}

    # -- tokens and the vocabulary -------------------------------------------
    def tokens(self, t):
        """A batch's tokens or labels [b, S/M] over the group's whole
        sequence."""
        return self.comm.all_gather_dim(t, 1)

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
