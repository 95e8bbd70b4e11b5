"""Map the JAX package's parameters onto the port's modules.

``params_from_jax(np_params, cfg)`` takes a JAX param pytree with every
leaf already converted to a numpy array (the caller does
``jax.tree.map(np.asarray, params)``) and returns a ``state_dict`` for the
port's model of ``cfg.family``.  It imports no JAX.

* Layouts match: both packages keep weights ``(in, out)`` for ``x @ W``,
  so nothing is transposed.
* Dense and MoE (``TransformerLM``): ``params["blocks"]`` is stacked on a
  leading layer axis (the JAX init vmaps over layers); the port holds one
  module per layer, so the axis is split.  An MoE model's unscanned
  ``params["lead_blocks"]`` (a list, dense FFNs) become the port's first
  layers and the stacked blocks the rest, the order of the KV cache and
  the page pool in both packages.  The experts bridge as they are:
  ``moe.w_gate``/``w_up`` ``(E, D, F)``, ``moe.w_down`` ``(E, F, D)``,
  ``moe.shared.*``; ``moe.router`` stays float32.  ``lm_head`` bridges
  where the config unties it.
* Hybrid (``GriffinLM``): ``params["groups"][f"b{i}"]`` is stacked on a
  leading group axis; group g, position i becomes layer ``3g + i`` of the
  port's block list, and ``params["leftover"][j]`` the layers after the
  groups.  The RG-LRU's ``b_a``, ``b_x`` and ``lam`` stay float32, as the
  JAX init makes them.
* VLM: the dense tree (the patch embeddings are request inputs, not
  weights).
* ssm (``XLSTMLM``): ``params["pairs"]`` is stacked on a leading pair
  axis; pair p becomes ``pairs.{p}.mlstm.*`` / ``pairs.{p}.slstm.*``.
* audio (``EncDecLM``): ``params["enc_blocks"]`` and
  ``params["dec_blocks"]`` are stacked on a leading layer axis and split
  into ``enc_blocks.{i}.*`` / ``dec_blocks.{i}.*`` (LayerNorms as
  ``ln*.w``/``ln*.b``, the decoder's cross-attention as ``xattn.*``);
  ``enc_ln``, ``dec_ln`` and the tied ``embed`` keep their names.
* A bf16 JAX array arrives as an ``ml_dtypes`` bfloat16 numpy array,
  which ``torch.from_numpy`` rejects; every leaf goes through float32
  (exact for bf16) and is then cast to its dtype in the port.
* A tree shaped like the params (a gradient, an AdamW moment) maps the
  same way; ``dtype`` then names the one dtype of every leaf.
  ``opt_state_from_jax`` carries the JAX optimizer state ``{"m", "v",
  "step"}`` over with its moments kept float32, as both optimizers keep
  them.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

_F32_LEAVES = ("rg.b_a", "rg.b_x", "rg.lam", "moe.router")


def _tensor(a, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy()).to(dtype)


def _flatten(tree, prefix: str = ""):
    """Nested dicts -> {"a.b.c": leaf}."""
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def params_from_jax(np_params, cfg: ModelConfig,
                    dtype: Optional[torch.dtype] = None
                    ) -> Dict[str, torch.Tensor]:
    """JAX params (numpy leaves) -> port state_dict for ``cfg.family``:
    each leaf in ``cfg.dtype`` (``_F32_LEAVES`` in float32), or every leaf
    in ``dtype`` when it is given."""
    if cfg.family not in ("dense", "moe", "vlm", "hybrid", "ssm", "audio"):
        raise NotImplementedError(f"family {cfg.family!r} is not bridged")
    f32_dtype = dtype or torch.float32
    dtype = dtype or getattr(torch, cfg.dtype)
    sd = {"embed": _tensor(np_params["embed"], dtype)}

    def put(prefix: str, tree, index=None):
        for name, leaf in _flatten(tree):
            a = leaf if index is None else leaf[index]
            sd[f"{prefix}.{name}"] = _tensor(
                a, f32_dtype if name in _F32_LEAVES else dtype)

    if cfg.family == "audio":
        for stack, n in (("enc_blocks", cfg.enc_layers),
                         ("dec_blocks", cfg.num_layers)):
            for i in range(n):
                put(f"{stack}.{i}", np_params[stack], i)
        put("enc_ln", np_params["enc_ln"])
        put("dec_ln", np_params["dec_ln"])
        return sd
    sd["final_norm"] = _tensor(np_params["final_norm"], dtype)
    if cfg.family == "ssm":
        for i in range(cfg.num_layers // 2):
            put(f"pairs.{i}", np_params["pairs"], i)
        return sd
    if "lm_head" in np_params:
        sd["lm_head"] = _tensor(np_params["lm_head"], dtype)
    if cfg.family == "hybrid":
        glen = len(cfg.block_pattern or ("rglru", "rglru", "attn"))
        n_groups = cfg.num_layers // glen
        for g in range(n_groups):
            for i in range(glen):
                put(f"blocks.{glen * g + i}", np_params["groups"][f"b{i}"], g)
        for j, block in enumerate(np_params["leftover"]):
            put(f"blocks.{glen * n_groups + j}", block)
        return sd
    lead = np_params.get("lead_blocks", [])
    for i, block in enumerate(lead):
        put(f"blocks.{i}", block)
    for i in range(cfg.num_layers - len(lead)):
        put(f"blocks.{len(lead) + i}", np_params["blocks"], i)
    return sd


def opt_state_from_jax(np_state, cfg: ModelConfig) -> Dict:
    """The JAX AdamW state ``{"m", "v", "step"}`` (numpy leaves) -> the
    port's: moments keyed as the model's parameters, float32, and the step
    as an int32 host tensor."""
    return {"m": params_from_jax(np_state["m"], cfg, dtype=torch.float32),
            "v": params_from_jax(np_state["v"], cfg, dtype=torch.float32),
            "step": torch.tensor(int(np_state["step"]), dtype=torch.int32)}
