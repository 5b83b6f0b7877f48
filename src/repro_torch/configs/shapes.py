"""Assigned input shapes × skip rules, and meta-tensor input specs —
counterpart of ``repro.configs.shapes``.

Shapes:
    train_4k     seq 4096,   global_batch 256   (train_step)
    prefill_32k  seq 32768,  global_batch 32    (inference prefill)
    decode_32k   seq 32768,  global_batch 128   (one-token decode, 32k cache)
    long_500k    seq 524288, global_batch 1     (long-context decode)

Skip rules:
    * long_500k only for sub-quadratic archs (mamba2, recurrentgemma);
    * decode shapes skipped for encoder-only archs (hubert);
    * hubert prefill_32k = a 32k-frame encoder forward.

The reference's ``ShapeDtypeStruct`` stand-ins are tensors on the meta
device here: the same keys, shapes and dtypes, no memory. Its ``int32``
tokens and labels are ``torch.long``, the index type the port's embedding
lookup and the loss's ``gather`` take.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.model import ModelConfig, init_cache


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

SUBQUADRATIC = {"mamba2-1.3b", "recurrentgemma-2b"}
ENCODER_ONLY = {"hubert-xlarge"}
NO_DECODE = "encoder-only arch has no decode step"


def skip_reason(cfg: ModelConfig, shape: str) -> str | None:
    if shape == "long_500k" and cfg.name not in SUBQUADRATIC:
        return "long_500k needs sub-quadratic attention (full-attention arch)"
    if cfg.name in ENCODER_ONLY and SHAPES[shape].kind == "decode":
        return NO_DECODE
    return None


def cells(cfg: ModelConfig) -> list[str]:
    return [s for s in SHAPES if skip_reason(cfg, s) is None]


def input_specs(cfg: ModelConfig, shape: str, *, batch_override=None):
    """Meta tensors for every model input of this cell: the batch that
    ``train_step`` / ``prefill_step`` / ``decode_step`` take. ``shape`` is
    a name of ``SHAPES`` or a ``ShapeSpec`` (a cell cut to a run's size)."""
    sp = SHAPES[shape] if isinstance(shape, str) else shape
    B = batch_override or sp.global_batch
    S = sp.seq_len
    f = cfg.compute_dtype

    def spec(shape, dtype=torch.long):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cfg.family == "audio":
        feats = spec((B, S, cfg.feat_in), f)
        if sp.kind == "train":
            return {"features": feats, "labels": spec((B, S))}
        return {"features": feats}

    if sp.kind == "train":
        batch = {"tokens": spec((B, S)), "labels": spec((B, S))}
    elif sp.kind == "prefill":
        batch = {"tokens": spec((B, S))}
    else:  # decode: one new token; the cache spec is built separately
        batch = {"tokens": spec((B, 1))}

    if cfg.family == "vlm" and sp.kind != "decode":
        batch["patches"] = spec((B, cfg.n_patches, cfg.d_model), f)
    return batch


def cache_specs(cfg: ModelConfig, shape: str, *, batch_override=None):
    """The decode cache at this cell's seq_len, on the meta device."""
    sp = SHAPES[shape] if isinstance(shape, str) else shape
    B = batch_override or sp.global_batch
    return init_cache(cfg, B, sp.seq_len, device="meta")
