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

``all_configs()`` maps every arch to its full config, and
``input_shapes(cfg, shape)`` gives the dry run's step inputs of one
(arch, shape) cell as ``(shape, dtype)`` pairs.
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import (SHAPES, ModelConfig, MoEConfig,
                                      ShapeSpec, round_up, shape_applicable)

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


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


# ---------------------------------------------------------------------------
# dry-run inputs (shapes and dtypes; the dry run makes them on "meta")
# ---------------------------------------------------------------------------

def input_shapes(cfg: ModelConfig, shape: ShapeSpec
                 ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """The step inputs of one (arch, shape) cell as ``{name: (shape,
    dtype)}``: the JAX package's ``configs.input_specs``, which returns
    ``ShapeDtypeStruct``s.  It has another name here because the port's
    ``distribution.sharding.input_specs`` already gives these inputs'
    placement specs.

    train  -> {tokens, labels}
    prefill-> {tokens}
    decode -> {token} (one new token; the step's cache is the model's
              ``init_cache``)
    The modality frontends are stubs: audio adds ``frames`` (B, enc_len,
    D), precomputed frame embeddings, and vlm ``patch_embeds`` (B, P, D).
    """
    i32, bf16 = torch.int32, torch.bfloat16
    B, S = shape.global_batch, shape.seq_len
    out: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    if shape.kind == "train":
        out["tokens"] = ((B, S), i32)
        out["labels"] = ((B, S), i32)
    elif shape.kind == "prefill":
        out["tokens"] = ((B, S), i32)
    elif shape.kind == "decode":
        out["token"] = ((B,), i32)
    else:
        raise ValueError(shape.kind)
    if cfg.family == "audio" and shape.kind != "decode":
        out["frames"] = ((B, min(cfg.enc_max_len, S), cfg.d_model), bf16)
    if cfg.family == "vlm" and shape.kind != "decode":
        out["patch_embeds"] = ((B, cfg.num_patches, cfg.d_model), bf16)
    return out


__all__ = ["ModelConfig", "MoEConfig", "ShapeSpec", "SHAPES", "ARCH_IDS",
           "get_config", "get_smoke", "all_configs", "input_shapes",
           "shape_applicable", "round_up"]
