"""Map the JAX package's parameters onto the port's modules.

``params_from_jax(np_params, cfg)`` takes a JAX param pytree with every
leaf already converted to a numpy array (the caller does
``jax.tree.map(np.asarray, params)``) and returns a ``state_dict`` for the
port's model of ``cfg.family``.  It imports no JAX.

* Layouts match: both packages keep weights ``(in, out)`` for ``x @ W``,
  so nothing is transposed.
* Dense (``TransformerLM``): ``params["blocks"]`` is stacked on a leading
  layer axis (the JAX init vmaps over layers); the port holds one module
  per layer, so the axis is split.
* Hybrid (``GriffinLM``): ``params["groups"][f"b{i}"]`` is stacked on a
  leading group axis; group g, position i becomes layer ``3g + i`` of the
  port's block list, and ``params["leftover"][j]`` the layers after the
  groups.  The RG-LRU's ``b_a``, ``b_x`` and ``lam`` stay float32, as the
  JAX init makes them.
* A bf16 JAX array arrives as an ``ml_dtypes`` bfloat16 numpy array,
  which ``torch.from_numpy`` rejects; every leaf goes through float32
  (exact for bf16) and is then cast to its dtype in the port.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

_F32_LEAVES = ("rg.b_a", "rg.b_x", "rg.lam")


def _tensor(a, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy()).to(dtype)


def _flatten(tree, prefix: str = ""):
    """Nested dicts -> {"a.b.c": leaf}."""
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def _hybrid(np_params, cfg: ModelConfig, dtype) -> Dict[str, torch.Tensor]:
    glen = len(cfg.block_pattern or ("rglru", "rglru", "attn"))
    n_groups = cfg.num_layers // glen
    sd = {"embed": _tensor(np_params["embed"], dtype),
          "final_norm": _tensor(np_params["final_norm"], dtype)}

    def put(layer: int, block, index=None):
        for name, leaf in _flatten(block):
            a = leaf if index is None else leaf[index]
            sd[f"blocks.{layer}.{name}"] = _tensor(
                a, torch.float32 if name in _F32_LEAVES else dtype)

    for g in range(n_groups):
        for i in range(glen):
            put(glen * g + i, np_params["groups"][f"b{i}"], g)
    for j, block in enumerate(np_params["leftover"]):
        put(glen * n_groups + j, block)
    return sd


def params_from_jax(np_params, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """JAX params (numpy leaves) -> port state_dict for ``cfg.family``."""
    dtype = getattr(torch, cfg.dtype)
    if cfg.family == "hybrid":
        return _hybrid(np_params, cfg, dtype)
    if cfg.family != "dense" or "lead_blocks" in np_params:
        raise NotImplementedError("only the dense and hybrid families are "
                                  "bridged")
    sd = {"embed": _tensor(np_params["embed"], dtype),
          "final_norm": _tensor(np_params["final_norm"], dtype)}
    if "lm_head" in np_params:
        sd["lm_head"] = _tensor(np_params["lm_head"], dtype)
    blocks = np_params["blocks"]
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}."
        sd[pre + "ln1"] = _tensor(blocks["ln1"][i], dtype)
        sd[pre + "ln2"] = _tensor(blocks["ln2"][i], dtype)
        for group in ("attn", "ffn"):
            for name, stacked in blocks[group].items():
                sd[f"{pre}{group}.{name}"] = _tensor(stacked[i], dtype)
    return sd
