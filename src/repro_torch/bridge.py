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
* ``jax_leaves(names, cfg)`` is the reverse of this naming: for every
  port parameter name, the JAX leaf's path and, for a block split from a
  stacked axis, its index along that axis and the axis's length (the
  distribution layer's placements read the JAX policy's spec there).
"""
from __future__ import annotations

from typing import Dict, Iterable, NamedTuple, Optional

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


class JaxLeaf(NamedTuple):
    """Where a port parameter comes from in the JAX pytree: the leaf's
    path (``/blocks/attn/wq``), and where the leaf is stacked on a leading
    layer axis, the index along it and its length (else None)."""
    path: str
    index: Optional[int]
    stacked: Optional[int]


def _block_layout(cfg: ModelConfig):
    """``(port prefix, JAX path, index, stacked length)`` of every block
    (and of the encoder-decoder's final LayerNorms), in the order the
    port's ``state_dict`` holds them; ``index`` and the length are None
    for a block the JAX tree does not stack."""
    if cfg.family == "audio":
        for stack, n in (("enc_blocks", cfg.enc_layers),
                         ("dec_blocks", cfg.num_layers)):
            for i in range(n):
                yield f"{stack}.{i}", (stack,), i, n
        yield "enc_ln", ("enc_ln",), None, None
        yield "dec_ln", ("dec_ln",), None, None
    elif cfg.family == "ssm":
        n = cfg.num_layers // 2
        for i in range(n):
            yield f"pairs.{i}", ("pairs",), i, n
    elif cfg.family == "hybrid":
        glen = len(cfg.block_pattern or ("rglru", "rglru", "attn"))
        n_groups = cfg.num_layers // glen
        for g in range(n_groups):
            for i in range(glen):
                yield f"blocks.{glen * g + i}", ("groups", f"b{i}"), g, \
                    n_groups
        for j in range(cfg.num_layers - glen * n_groups):
            yield f"blocks.{glen * n_groups + j}", ("leftover", j), None, None
    else:
        n_lead = cfg.moe.first_dense_layers if cfg.moe else 0
        for i in range(n_lead):
            yield f"blocks.{i}", ("lead_blocks", i), None, None
        n = cfg.num_layers - n_lead
        for i in range(n):
            yield f"blocks.{n_lead + i}", ("blocks",), i, n


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
    if cfg.family != "audio":
        sd["final_norm"] = _tensor(np_params["final_norm"], dtype)
    if cfg.family not in ("audio", "ssm") and "lm_head" in np_params:
        sd["lm_head"] = _tensor(np_params["lm_head"], dtype)
    for prefix, path, index, _ in _block_layout(cfg):
        tree = np_params
        for key in path:
            tree = tree[key]
        for name, leaf in _flatten(tree):
            a = leaf if index is None else leaf[index]
            sd[f"{prefix}.{name}"] = _tensor(
                a, f32_dtype if name in _F32_LEAVES else dtype)
    return sd


def jax_leaves(names: Iterable[str], cfg: ModelConfig
               ) -> Dict[str, JaxLeaf]:
    """The reverse of ``params_from_jax``'s naming: for each port
    parameter name of a ``cfg`` model, the JAX leaf it comes from."""
    layout = [(prefix + ".", path, index, n)
              for prefix, path, index, n in _block_layout(cfg)]
    out = {}
    for name in names:
        for prefix, path, index, n in layout:
            if name.startswith(prefix):
                parts = [str(p) for p in path] + \
                    name[len(prefix):].split(".")
                out[name] = JaxLeaf("/" + "/".join(parts), index, n)
                break
        else:
            out[name] = JaxLeaf("/" + name.replace(".", "/"), None, None)
    return out


def opt_state_from_jax(np_state, cfg: ModelConfig) -> Dict:
    """The JAX AdamW state ``{"m", "v", "step"}`` (numpy leaves) -> the
    port's: moments keyed as the model's parameters, float32, and the step
    as an int32 host tensor."""
    return {"m": params_from_jax(np_state["m"], cfg, dtype=torch.float32),
            "v": params_from_jax(np_state["v"], cfg, dtype=torch.float32),
            "step": torch.tensor(int(np_state["step"]), dtype=torch.int32)}
