"""Architecture config registry: ``get_config(arch_id)`` / ``ARCHS``.

The port's own copy of ``repro.configs``. Only the architectures whose model
family the port runs are listed; the audio and vlm archs arrive with their
slice and raise ``NotImplementedError`` until then.
"""

from __future__ import annotations

import dataclasses
from importlib import import_module

ARCHS = [
    "granite-moe-3b-a800m",
    "dbrx-132b",
    "olmo-1b",
    "llama3_2-3b",
    "qwen2-1_5b",
    "gemma-2b",
    "recurrentgemma-2b",
    "mamba2-1_3b",
    "deepseek-moe-paper",      # the paper's §5.2 module (EP benchmark)
]

# The reference's archs of families the port does not run yet.
_LATER = {
    "hubert-xlarge": "the audio/vlm slice",
    "internvl2-26b": "the audio/vlm slice",
}

_ALIASES = {
    "llama3.2-3b": "llama3_2-3b",
    "qwen2-1.5b": "qwen2-1_5b",
    "mamba2-1.3b": "mamba2-1_3b",
}


def canonical(arch: str) -> str:
    return _ALIASES.get(arch, arch)


def _module(arch: str):
    name = canonical(arch)
    if name in _LATER:
        raise NotImplementedError(
            f"{arch!r} is not ported yet; it comes with {_LATER[name]}")
    if name not in ARCHS:
        raise NotImplementedError(
            f"{arch!r} is not ported; the port serves {ARCHS}")
    return import_module(f"repro_torch.configs.{name.replace('-', '_')}")


def get_config(arch: str, **overrides):
    cfg = _module(arch).config()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def get_smoke_config(arch: str):
    return _module(arch).smoke_config()
