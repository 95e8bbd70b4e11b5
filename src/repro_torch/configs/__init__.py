"""Architecture registry of the port.

``get_config(arch)`` returns the full config and ``get_smoke(arch)`` the
reduced same-family config the CPU tests use.  The port serves all ten
archs of the JAX package: the dense ``qwen3-1.7b``, ``qwen3-8b``,
``llama3.2-3b`` and ``deepseek-67b``, the MoE ``deepseek-moe-16b`` and
``mixtral-8x22b`` (sliding-window attention over a ring cache), the
hybrid ``recurrentgemma-2b``, the VLM ``internvl2-2b``, the ssm
``xlstm-350m`` and the encoder-decoder ``whisper-tiny``.  At full depth
``mixtral-8x22b`` and ``deepseek-67b`` need more than one 80 GB card.
An arch name neither package has raises ``KeyError``.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (SHAPES, ModelConfig, MoEConfig,
                                      ShapeSpec, round_up)

_MODULES = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mixtral-8x22b": "mixtral_8x22b",
    "whisper-tiny": "whisper_tiny",
    "deepseek-67b": "deepseek_67b",
    "llama3.2-3b": "llama32_3b",
    "qwen3-1.7b": "qwen3_1_7b",
    "qwen3-8b": "qwen3_8b",
    "internvl2-2b": "internvl2_2b",
    "xlstm-350m": "xlstm_350m",
    "recurrentgemma-2b": "recurrentgemma_2b",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


__all__ = ["ModelConfig", "MoEConfig", "ShapeSpec", "SHAPES", "ARCH_IDS",
           "get_config", "get_smoke", "round_up"]
