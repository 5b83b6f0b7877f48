"""Ambient overrides the model reads — counterpart of ``repro.parallel.ctx``.

Context managers and readers on a ``threading.local``, as in the
reference:

* ``moe_impl_context(impl)`` / ``current_moe_impl()``: the MoE every
  ``attn_moe`` block runs when no ``moe_impl`` is passed
  (``models.model._moe_half``);
* ``flash_decode_context(impl)`` / ``current_flash_decode()``: the sharded
  one-token attention when no ``flash_decode`` is passed
  (``models.layers.attention``); where the impl returns ``None`` the dense
  path runs;
* ``activation_sharding(spec)`` / ``constrain_activation(x)`` and
  ``head_sharding(spec)`` / ``constrain_heads(x)``: the reference's
  sharding constraints. In one process they place nothing and return their
  input unchanged;
* ``tensor_parallel_context(tp)`` / ``current_tensor_parallel()``: what
  places the tp_sp mode across processes in their stead, a
  :class:`repro_torch.parallel.tp.TensorParallel` (``launch.steps`` sets
  it for a train step on a process mesh). ``models.model`` and
  ``models.layers.attention`` read it: the embedding and the cross
  entropy over the vocabulary blocks, the heads, the sequence-parallel
  residual and the FSDP gathers of each layer;
* ``cache_blocks_context(cb)`` / ``current_cache_blocks()``: a serving
  step's cache on a process mesh, of which each rank holds its
  ``cache_spec`` blocks (:class:`repro_torch.parallel.tp.CacheBlocks`;
  ``launch.steps`` sets it around a prefill or decode step there). The
  attention, SSM and RG-LRU blocks read it where they get a cache.

An explicit argument always wins over the ambient value.
"""

from __future__ import annotations

import contextlib
import threading

_CTX = threading.local()


@contextlib.contextmanager
def _ambient(key: str, value):
    prev = getattr(_CTX, key, None)
    setattr(_CTX, key, value)
    try:
        yield
    finally:
        setattr(_CTX, key, prev)


def activation_sharding(spec):
    """Set the residual stream's placement for code run under this
    context."""
    return _ambient("spec", spec)


def constrain_activation(x):
    """``x`` unchanged: one process places nothing."""
    return x


def head_sharding(spec):
    """Placement of [B, S, H, hd] attention tensors (TP over heads)."""
    return _ambient("head_spec", spec)


def constrain_heads(x, n_heads_axis=2):
    """``x`` unchanged: one process places nothing."""
    return x


def tensor_parallel_context(tp):
    """Ambient tensor and sequence parallelism of a process mesh."""
    return _ambient("tp", tp)


def current_tensor_parallel():
    return getattr(_CTX, "tp", None)


def flash_decode_context(impl):
    """Ambient sharded one-token-decode attention override."""
    return _ambient("flash_decode", impl)


def current_flash_decode():
    return getattr(_CTX, "flash_decode", None)


def moe_impl_context(impl):
    """Ambient MoE execution override (EP path injection, same pattern)."""
    return _ambient("moe_impl", impl)


def current_moe_impl():
    return getattr(_CTX, "moe_impl", None)


def cache_blocks_context(cb):
    """Ambient cache placement of a serving step on a process mesh."""
    return _ambient("cache_blocks", cb)


def current_cache_blocks():
    return getattr(_CTX, "cache_blocks", None)
