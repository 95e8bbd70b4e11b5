"""Map the JAX package's parameters onto the port's module.

``params_from_jax(np_params, cfg)`` takes the JAX ``TransformerLM``
param pytree with every leaf already converted to a numpy array (the
caller does ``jax.tree.map(np.asarray, params)``) and returns a
``state_dict`` for ``repro_torch``'s ``TransformerLM``.  It imports no
JAX.

* Layouts match: both packages keep weights ``(in, out)`` for ``x @ W``,
  so nothing is transposed.
* ``params["blocks"]`` is stacked on a leading layer axis (the JAX init
  vmaps over layers); the port holds one module per layer, so the axis is
  split.
* A bf16 JAX array arrives as an ``ml_dtypes`` bfloat16 numpy array,
  which ``torch.from_numpy`` rejects; every leaf goes through float32
  (exact for bf16) and is then cast to ``cfg.dtype``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _tensor(a, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy()).to(dtype)


def params_from_jax(np_params, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """JAX dense-transformer params (numpy leaves) -> port state_dict."""
    if cfg.family != "dense" or "lead_blocks" in np_params:
        raise NotImplementedError("only the dense family is bridged")
    dtype = getattr(torch, cfg.dtype)
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
