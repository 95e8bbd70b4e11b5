"""Architecture registry of the port.

``get_config(arch)`` returns the full config and ``get_smoke(arch)`` the
reduced same-family config the CPU tests use.  The port serves the dense
``qwen3-1.7b`` and the hybrid ``recurrentgemma-2b`` so far; other archs
raise ``KeyError`` (ROADMAP Queue 1 lists the families still to port).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, MoEConfig, round_up

_MODULES = {
    "qwen3-1.7b": "qwen3_1_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"arch {arch!r} is not ported yet; ported: "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


__all__ = ["ModelConfig", "MoEConfig", "ARCH_IDS", "get_config",
           "get_smoke", "round_up"]
