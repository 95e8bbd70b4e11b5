"""Divisibility-aware sharding policy: TP over "model", FSDP over
("pod","data"), on ``torch.distributed``'s ``DeviceMesh`` and DTensor.

The counterpart of ``repro/distribution/sharding.py``.  A sharding mesh
must divide the dims it shards, so the policy proves divisibility before
sharding and falls back per tensor:

* named rules first (embeddings vocab-sharded, attention projections
  column/row split, MoE expert dim, router replicated);
* generic fallback: largest dim divisible by the axis size;
* anything that doesn't divide is replicated on that axis — e.g.
  llama3.2-3b's 24 heads on a 16-way model axis keep head projections
  replicated while its d_ff=8192 still TP-shards (the policy operates
  per-tensor, so partial TP comes out naturally).

**Specs.** A spec is a tuple with one entry per tensor dim: ``None``
(replicated), a mesh axis name, or a tuple of names (that dim split over
those axes, the first axis major).  It is the JAX ``PartitionSpec``'s
content, and ``_spec_for_leaf`` builds it by the JAX function's lines.
``to_placements`` turns a spec into DTensor placements, one per mesh dim:
``Shard(d)`` on every mesh axis named at tensor dim ``d``, ``Replicate()``
elsewhere.  DTensor splits a dim sharded on several mesh dims in mesh-dim
order, so ("pod", "data") in a ("pod", "data", "model") mesh is
pod-major, as JAX lays it out.

**Meshes.** Every function takes anything that gives axis sizes by name:
a ``DeviceMesh`` (its ``mesh_dim_names`` and ``shape``) or an object whose
``shape`` is a dict ``{axis: size}`` (``axis_sizes``).

**Parameters.** The JAX policy runs on the JAX pytree, whose blocks are
stacked on a leading layer axis that it never shards (paths matching
``blocks|pairs|groups``).  The port holds one module per layer, so a
port parameter takes the JAX spec of the leaf it was split from
(``bridge.jax_leaves``: its path, at the stacked shape) with the stacked
entry dropped; ``_spec_for_leaf`` is not run on the port's own per-layer
name and shape, whose first dim the same rule would skip.  An unstacked
JAX leaf whose path matches the rule (deepseek-moe-16b's
``/lead_blocks/<i>/...``) keeps its first dim unsharded, as in JAX.
``param_specs``/``param_shardings`` apply to a ``state_dict`` and to each
of the optimizer's moment dicts alike (JAX's policy gives a moment the
spec of its parameter).

``*_specs`` return specs, ``*_shardings`` the same as placements.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

from torch.distributed.tensor import Replicate, Shard

from repro_torch.bridge import jax_leaves
from repro_torch.configs.base import ModelConfig, ShapeSpec

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in mesh-dim order, of a ``DeviceMesh`` or of
    an object whose ``shape`` is such a dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


@dataclass(frozen=True)
class ShardingPolicy:
    tp_axis: str = "model"
    fsdp_axes: Tuple[str, ...] = ("data",)      # ("pod","data") multi-pod
    fsdp_params: bool = True                    # shard params at rest
    # activation batch axes (data parallel)
    batch_axes: Tuple[str, ...] = ("data",)

    @staticmethod
    def for_mesh(mesh, fsdp_params: bool = True) -> "ShardingPolicy":
        if "pod" in axis_sizes(mesh):
            return ShardingPolicy(fsdp_axes=("pod", "data"),
                                  batch_axes=("pod", "data"),
                                  fsdp_params=fsdp_params)
        return ShardingPolicy(fsdp_params=fsdp_params)


def _axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _spec_for_leaf(path: str, shape: Sequence[int], mesh,
                   pol: ShardingPolicy) -> Spec:
    tp_n = _axis_size(mesh, pol.tp_axis)
    fsdp_n = _axis_size(mesh, pol.fsdp_axes)
    ndims = len(shape)
    entries: list = [None] * ndims
    if ndims == 0:
        return ()

    # leading dims of stacked/scanned blocks are layer dims — skip them:
    # heuristic: paths under blocks/pairs/groups have stacked leaves
    first_ok = 0
    if re.search(r"(blocks|pairs|groups)", path) and ndims >= 2:
        first_ok = 1
    cand_dims = list(range(first_ok, ndims))

    def try_assign(dim: int, axes) -> bool:
        n = _axis_size(mesh, axes)
        if dim in cand_dims and entries[dim] is None and shape[dim] % n == 0 \
                and shape[dim] >= n:
            entries[dim] = axes if isinstance(axes, str) else tuple(axes)
            return True
        return False

    # ---- named rules (TP placement) -----------------------------------
    leaf = path.split("/")[-1]
    tp_done = False
    if leaf in ("embed",):
        tp_done = try_assign(first_ok + 0, pol.tp_axis)       # vocab dim
    elif leaf in ("lm_head",):
        tp_done = try_assign(ndims - 1, pol.tp_axis)          # vocab dim
    elif leaf in ("wq", "wk", "wv", "w_gate", "w_up", "w_in", "w_gates",
                  "w_if"):
        tp_done = try_assign(ndims - 1, pol.tp_axis)          # column split
    elif leaf in ("wo", "w_down", "w_out"):
        tp_done = try_assign(ndims - 2, pol.tp_axis)          # row split
    elif leaf == "router":
        tp_done = True                                         # replicate
    elif re.search(r"moe", path) and ndims >= 3:
        # (L?, E, D, F) expert tensors: expert dim first, else F
        tp_done = (try_assign(first_ok, pol.tp_axis)
                   or try_assign(ndims - 1, pol.tp_axis))
    # generic fallback: largest divisible dim, preferring the last
    if not tp_done:
        for dim in sorted(cand_dims, key=lambda d: (-shape[d], -d)):
            if shape[dim] >= 2 * tp_n and try_assign(dim, pol.tp_axis):
                break

    # ---- FSDP placement over the remaining dims ------------------------
    if pol.fsdp_params and fsdp_n > 1:
        for dim in sorted(cand_dims, key=lambda d: (-shape[d], d)):
            if try_assign(dim, pol.fsdp_axes):
                break

    return tuple(entries)


def to_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements, one per mesh dim, of ``spec``: ``Shard(d)`` on
    each mesh axis named at tensor dim ``d``, ``Replicate()`` elsewhere.
    A dim's axes must be in mesh-dim order (DTensor splits in that order)
    and no axis may shard two dims."""
    names = list(axis_sizes(mesh))
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"to_placements: {axes} at dim {dim} is not in "
                             f"the mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"to_placements: axis {names[i]!r} shards "
                                 f"two dims of {spec}")
            out[i] = Shard(dim)
    return tuple(out)


def _placed(specs: Mapping[str, Spec], mesh) -> Dict[str, tuple]:
    return {n: to_placements(s, mesh) for n, s in specs.items()}


def param_specs(params: Mapping[str, Any], mesh,
                pol: Optional[ShardingPolicy] = None, *,
                cfg: ModelConfig) -> Dict[str, Spec]:
    """Spec of every tensor of a port ``state_dict`` (anything with a
    ``shape``, meta tensors included) of a ``cfg`` model."""
    pol = pol or ShardingPolicy.for_mesh(mesh)
    out = {}
    for name, leaf in jax_leaves(params, cfg).items():
        shape = tuple(params[name].shape)
        if leaf.stacked is None:
            out[name] = _spec_for_leaf(leaf.path, shape, mesh, pol)
        else:
            out[name] = _spec_for_leaf(leaf.path, (leaf.stacked,) + shape,
                                       mesh, pol)[1:]
    return out


def param_shardings(params: Mapping[str, Any], mesh,
                    pol: Optional[ShardingPolicy] = None, *,
                    cfg: ModelConfig) -> Dict[str, tuple]:
    """``{name: placements}`` of a port ``state_dict``: ``param_specs``
    as DTensor placements."""
    return _placed(param_specs(params, mesh, pol, cfg=cfg), mesh)


def input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh,
                pol: Optional[ShardingPolicy] = None) -> Dict[str, Spec]:
    """Specs of the step inputs of one (arch, shape) cell."""
    pol = pol or ShardingPolicy.for_mesh(mesh)
    B = shape.global_batch
    bn = _axis_size(mesh, pol.batch_axes)
    batch_axes = pol.batch_axes if B % bn == 0 else (
        pol.batch_axes[:1] if B % _axis_size(mesh, pol.batch_axes[:1]) == 0
        else None)
    bspec = batch_axes if batch_axes else None

    out: Dict[str, Spec] = {}
    if shape.kind == "train":
        out["tokens"] = (bspec, None)
        out["labels"] = (bspec, None)
    elif shape.kind == "prefill":
        out["tokens"] = (bspec, None)
    else:
        out["token"] = (bspec,)
    if cfg.family == "audio" and shape.kind != "decode":
        out["frames"] = (bspec, None, None)
    if cfg.family == "vlm" and shape.kind != "decode":
        out["patch_embeds"] = (bspec, None, None)
    return out


def input_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh,
                    pol: Optional[ShardingPolicy] = None
                    ) -> Dict[str, tuple]:
    """``input_specs`` as DTensor placements."""
    return _placed(input_specs(cfg, shape, mesh, pol), mesh)


def cache_specs(cache: Mapping[str, Any], cfg: ModelConfig, mesh,
                batch: int, pol: Optional[ShardingPolicy] = None,
                batch_axes_tree: Optional[Mapping[str, int]] = None
                ) -> Dict[str, Spec]:
    """Specs of a dense decode cache (a model's ``init_cache``).

    KV time axis shards over "model" (the flash-decoding KV-split: each
    model shard owns a slice of the context; ``sharded_decode_attention``
    merges the partial softmax).  Batch shards over the data axes when
    divisible.  Recurrent state (B, D) shards D over "model".

    ``batch_axes_tree`` (from ``model.cache_batch_axes``) names each
    leaf's batch dim — stacked caches are (L, B, T, ...) while flat
    recurrent states are (B, ...).

    The port's caches keep the JAX leaves' layout, with one difference:
    a dense or MoE ``TransformerLM`` holds every layer's K/V in one
    ``k``/``v`` of ``(L, B, T, Hkv, Dh)``, where JAX splits the unscanned
    lead layers into ``lead_k``/``lead_v`` ``(n_lead, ...)`` from ``k``/
    ``v`` ``(L - n_lead, ...)``.  Only the leading layer axis differs,
    which no rule shards or reads, so the port's leaf takes the spec JAX
    gives both.  The engine's paged pool (``PagedKVCache``) has no JAX
    cache counterpart and no spec here.
    """
    pol = pol or ShardingPolicy.for_mesh(mesh)
    tp = pol.tp_axis
    tp_n = _axis_size(mesh, tp)
    bn = _axis_size(mesh, pol.batch_axes)
    b_ax = pol.batch_axes if batch % bn == 0 else None

    def one(key: str, shp: Sequence[int]) -> Spec:
        nd = len(shp)
        if nd == 0:
            return ()
        if key in ("length", "enc_len"):
            return (b_ax,)
        b_dim = 1
        if batch_axes_tree is not None:
            b_dim = batch_axes_tree.get(key, 1)
        if b_dim >= nd or shp[b_dim] != batch:
            b_dim = next((d for d in range(nd) if shp[d] == batch), None)
        entries: list = [None] * nd
        if b_dim is not None:
            entries[b_dim] = b_ax
        t_dim = None if b_dim is None else b_dim + 1
        if (t_dim is not None and nd >= t_dim + 3
                and shp[t_dim] % tp_n == 0 and shp[t_dim] >= tp_n):
            entries[t_dim] = tp                 # KV-seq split
        elif (entries[-1] is None and shp[-1] % tp_n == 0
                and shp[-1] >= 2 * tp_n):
            entries[-1] = tp
        return tuple(entries)

    return {k: one(k, tuple(t.shape)) for k, t in cache.items()}


def cache_shardings(cache: Mapping[str, Any], cfg: ModelConfig, mesh,
                    batch: int, pol: Optional[ShardingPolicy] = None,
                    batch_axes_tree: Optional[Mapping[str, int]] = None
                    ) -> Dict[str, tuple]:
    """``cache_specs`` as DTensor placements."""
    return _placed(cache_specs(cache, cfg, mesh, batch, pol,
                               batch_axes_tree), mesh)
