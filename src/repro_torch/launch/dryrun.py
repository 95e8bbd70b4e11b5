"""Multi-pod dry run: trace every (arch x shape x mesh) step without a card.

The counterpart of ``repro/launch/dryrun.py``, which compiles each cell
on 512 forced host devices and never touches a TPU.  The port's dry run
traces its program on the ``meta`` device over a fake process group and
never allocates: that is the design, not a fallback, and the CLI needs
no card.  The fake group (``torch.testing``'s ``FakeStore`` and its
``"fake"`` backend) is opened in this process, as rank 0 of 256 ranks
(16 x 16) or 512 (2 x 16 x 16); its collectives do nothing but give
results of the right shape.  The mesh is ``launch/mesh.make_mesh`` on
``"cpu"`` over that group; on 2 x 16 x 16 its ("pod", "data") axes place
DTensors as one flattened axis of 32 (``production_mesh``).  In its own
process the dry run lets DTensor reshard where XLA's partitioner does
unasked (``_dtensor_as_xla``: a ``view`` that would split a shard
unevenly redistributes, as ``reshape`` does).  That is the one placement
for uneven views, so the models need none of their own: the head views
of ``layers.attn_qkv`` and ``attn_out`` (8 KV heads on a 16-wide model
axis), the plain attention's (Hkv, G) view of the queries, the xLSTM's
gate and head views, whisper's cross-attention views.

``build_step`` builds a cell's step: the model on ``meta`` with
``attention_impl="torch"`` (JAX lowers ``"xla"``), its parameters
DTensors placed by ``param_shardings`` (FSDP for ``train``), the inputs
by ``input_shardings``, a decode's cache by ``cache_shardings``, the
sequence-parallel hints set from the policy.  ``run_cell`` runs the step
once under ``implicit_replication()`` (a plain tensor the step makes,
RoPE's positions for one, joins DTensors as replicated) and the op-cost
counter (``launch/op_cost.py``), so sharding mismatches and unsupported
placements surface as failures.  A cell that fails is recorded as
``status: "error"`` with its traceback and counted; nothing falls back.
Per cell it records, per device:

* FLOPs and HBM bytes from the counter (with trip counts), and the
  collective bytes by kind;
* ``memory.argument_bytes``, the local shard bytes of the parameters,
  the optimizer state, the inputs and the cache, and ``per_device_bytes``,
  that plus ``_activation_residency``; ``hbm_fit`` against the H100's
  ``HBM_BYTES``;
* ``trace_s`` (for JAX's ``lower_s``/``compile_s``).  JAX's
  ``xla_cost_flops`` (XLA's own count, a while body once) has no
  counterpart.

One JSON per cell goes under ``experiments/dryrun_torch/``, which the
roofline (``launch/roofline.py``) reads.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape prefill_32k
    python -m repro_torch.launch.dryrun --all [--multi-pod|--single-pod]

``--all`` runs every arch and shape on both meshes, ``--single-pod`` or
``--multi-pod`` with it one mesh (JAX's ``--all`` adds the 2 x 16 x 16
mesh even beside ``--single-pod``).  Cells run one mesh at a time, so
that the fake group is opened once for each.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Callable, Dict, Tuple

import torch
from torch import nn

from repro_torch.configs import (ARCH_IDS, SHAPES, get_config, input_shapes,
                                 shape_applicable)
from repro_torch.configs.base import HBM_BYTES, ModelConfig, ShapeSpec
from repro_torch.distribution.sharding import (ShardingPolicy, axis_sizes,
                                               cache_specs, input_specs,
                                               param_specs, to_placements)
from repro_torch.engine.models import build_model
from repro_torch.engine.models.layers import set_activation_sharding
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.op_cost import analyze_ops
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.trainer import TrainerConfig, make_train_step

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def fake_group(world: int) -> None:
    """Make the default process group a fake one of ``world`` ranks (this
    process is rank 0), unless it already is."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def production_mesh(multi_pod: bool):
    """The production mesh over a fake group of its size, on "cpu", as
    the mesh that places DTensors.  On 2 x 16 x 16 that is its ("pod",
    "data") axes flattened into one, "pod_data" (32): the policy shards a
    dim over ("pod", "data") and never over one of them alone, and
    DTensor's ops do not take a dim sharded on two mesh dims (or take it
    through slow bookkeeping); one axis of 32 gives every shard the same
    shape on the same ranks.  ``_axes(mesh)`` names the axes the policy
    sees."""
    shape, names = MESHES["pod2x16x16" if multi_pod else "pod16x16"]
    n = 1
    for s in shape:
        n *= s
    fake_group(n)
    _dtensor_as_xla()
    mesh = make_mesh(shape, names, device="cpu")
    if not multi_pod:
        return mesh
    mesh["pod", "data"]._flatten("pod_data")
    return mesh["pod_data", "model"]


class _Axes:
    """Axis sizes by name, as the sharding policy takes them."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)


def _axes(mesh):
    """The policy's axes of a placing mesh: "pod_data" read as ("pod",
    "data") of sizes 2 and its rest."""
    sizes = axis_sizes(mesh)
    if "pod_data" not in sizes:
        return mesh
    out = {"pod": 2, "data": sizes.pop("pod_data") // 2}
    out.update(sizes)
    return _Axes(out)


def _flat(entry):
    """A spec entry on the placing mesh: ("pod", "data") is "pod_data"."""
    return "pod_data" if entry == ("pod", "data") else entry


def _placements(specs: Dict[str, tuple], mesh) -> Dict[str, tuple]:
    return {n: to_placements(tuple(_flat(e) for e in spec), mesh)
            for n, spec in specs.items()}


_AS_XLA = []


def _dtensor_as_xla() -> None:
    """Let DTensor reshard where XLA's partitioner reshards unasked, in
    this process (a dry run's own), where DTensor raises otherwise: a
    ``view`` that would split or merge a sharded dim unevenly
    redistributes first, as ``reshape`` does; and a redistribution a
    DTensor cannot make in one step (a shard to a partial sum, on torch
    2.11) goes through the whole tensor (an all-gather, then the
    target)."""
    if _AS_XLA:
        return
    from torch.distributed.tensor import DTensor, Replicate, _api, _dispatch
    from torch.distributed.tensor import _redistribute
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor._ops import _view_ops
    aten = torch.ops.aten
    funcs = DTensor._op_dispatcher.sharding_propagator.op_strategy_funcs
    for op in (aten.view.default, aten._unsafe_view.default):
        strict = funcs[op]
        _view_ops.register_op_strategy_map(
            op, torch.Tensor.view, schema_info=RuntimeSchemaInfo(1),
            strict_view=False)
        lenient = funcs[op]

        def view_strategy(op_schema, strict=strict, lenient=lenient):
            # the view's own rule wherever it holds
            try:
                return strict(op_schema)
            except RuntimeError:
                return lenient(op_schema)

        funcs[op] = view_strategy
    inner = _redistribute.redistribute_local_tensor

    def redistribute_local_tensor(local, current, target, **kw):
        try:
            return inner(local, current, target, **kw)
        except RuntimeError as e:
            if "not supported yet" not in str(e):
                raise
        whole = DTensorSpec(current.mesh, (Replicate(),) * current.mesh.ndim,
                            tensor_meta=current.tensor_meta)
        return inner(inner(local, current, whole, **kw), whole, target, **kw)

    for mod in (_redistribute, _dispatch, _api):
        if hasattr(mod, "redistribute_local_tensor"):
            mod.redistribute_local_tensor = redistribute_local_tensor
    _AS_XLA.append(True)


# ---------------------------------------------------------------------------
def _activation_residency(cfg: ModelConfig, shape: ShapeSpec, mesh) -> int:
    """Analytic per-device activation residency (bytes), the JAX
    package's line for line.

    Train: remat keeps one hidden-state carry per layer plus one layer's
    working set (chunked-attention block scores, FFN intermediates).
    Inference: one layer's working set plus (decode) nothing: the cache
    is in the arguments.
    """
    sizes = axis_sizes(mesh)
    dp = 1
    for ax in ("pod", "data"):
        if ax in sizes:
            dp *= sizes[ax]
    tp = sizes.get("model", 1)
    B = max(shape.global_batch // dp, 1)
    S = shape.seq_len if shape.kind != "decode" else 1
    D = cfg.d_model
    L = cfg.num_layers
    hid = B * S * D * 2                              # bf16 hidden state
    ffn = max(cfg.d_ff, cfg.moe.d_ff_expert if cfg.moe else 0)
    work = 3 * hid + 2 * B * S * max(ffn // tp, D) * 2
    if shape.kind != "decode" and S > 1:
        skv = min(S, cfg.swa_window or S)
        bq = min(4 * 1024 * 1024 // max(skv, 1), S) or S
        scores = B * cfg.num_heads * bq * skv * 4
        work += scores
    if shape.kind == "train":
        return int(L * hid + 3 * work)               # fwd+bwd live sets
    return int(2 * work)


def _place(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def _local_bytes(tensors) -> int:
    """The bytes of this rank's shards of ``tensors``."""
    n = 0
    for t in tensors:
        local = t.to_local() if hasattr(t, "to_local") else t
        n += local.numel() * local.element_size()
    return n


def score_dims(cfg: ModelConfig, shape: ShapeSpec) -> set:
    """The KV lengths whose attention scores the hand kernels keep on
    chip, as the JAX dry run picks them."""
    dims = {shape.seq_len}
    if cfg.swa_window:
        dims.add(min(shape.seq_len, cfg.swa_window))
    if cfg.family == "hybrid":
        dims.add(min(shape.seq_len, cfg.local_attn_window))
    return dims


def build_step(cfg: ModelConfig, shape: ShapeSpec, mesh, remat: bool = True
               ) -> Tuple[Callable[[], Any], int]:
    """(step, argument bytes): ``step()`` runs one step of the cell on
    meta DTensors (call it under ``implicit_replication()``); the bytes
    are this rank's shards of the step's arguments.  Sets the
    sequence-parallel hints for ``mesh``.  A train step rematerializes
    its blocks, as JAX's does, unless ``remat`` is False."""
    cfg = cfg.replace(attention_impl="torch")
    train = shape.kind == "train"
    axes = _axes(mesh)
    pol = ShardingPolicy.for_mesh(axes, fsdp_params=train)
    batch = _flat(pol.batch_axes)
    set_activation_sharding(mesh, batch_axes=(
        (batch,) if isinstance(batch, str) else batch))
    model = build_model(cfg, device="meta")
    params = dict(model.named_parameters())
    p_sh = _placements(param_specs(params, axes, pol, cfg=cfg), mesh)
    for name, p in params.items():
        mod, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(mod), leaf, nn.Parameter(
            _place(p.detach(), mesh, p_sh[name]), requires_grad=train))
    params = dict(model.named_parameters())
    in_sh = _placements(input_specs(cfg, shape, axes, pol), mesh)
    inputs = {k: _place(torch.empty(s, dtype=dt, device="meta"), mesh,
                        in_sh[k])
              for k, (s, dt) in input_shapes(cfg, shape).items()}
    args = list(params.values()) + list(inputs.values())

    if train:
        tcfg = TrainerConfig(remat=remat, grad_accum=1,
                             adamw=AdamWConfig(total_steps=1000))
        opt = adamw_init(params)
        step = make_train_step(model, tcfg)
        args += list(opt["m"].values()) + list(opt["v"].values())
        return (lambda: step(opt, inputs)), _local_bytes(args)

    if shape.kind == "prefill":
        if cfg.family == "audio":
            def step():
                return model.prefill(inputs["tokens"], inputs["frames"])
        elif cfg.family == "vlm":
            def step():
                return model.prefill(inputs["tokens"],
                                     prefix_embeds=inputs["patch_embeds"])
        else:
            def step():
                return model.prefill(inputs["tokens"])
        return step, _local_bytes(args)

    # decode: one new token against a seq_len-deep cache
    B = shape.global_batch
    cache = model.init_cache(B, shape.seq_len)
    c_sh = _placements(cache_specs(
        cache, cfg, axes, B, pol,
        batch_axes_tree=model.cache_batch_axes(cache)), mesh)
    cache = {k: _place(v, mesh, c_sh[k]) for k, v in cache.items()}
    args += list(cache.values())
    return (lambda: model.decode_step(inputs["token"], cache)), \
        _local_bytes(args)


# ---------------------------------------------------------------------------
def _mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = OUT_DIR) -> Dict[str, Any]:
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = _mesh_name(multi_pod)
    cell: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                            "mesh": mesh_name}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        cell.update(status="skipped", reason=why)
        return cell

    t0 = time.time()
    try:
        mesh = production_mesh(multi_pod)
        step, arg_b = build_step(cfg, shape, mesh)
        with implicit_replication():
            cost = analyze_ops(step, score_dims=score_dims(cfg, shape))
        est = arg_b + _activation_residency(cfg, shape, _axes(mesh))
        cell.update(
            status="ok",
            devices=mesh.size(),
            flops=cost["flops"],
            bytes_accessed=cost["bytes"],
            score_bytes=cost["score_bytes"],
            collectives={k: v for k, v in cost.items()
                         if k.startswith("coll")},
            memory={"argument_bytes": arg_b},
            per_device_bytes=est,
            hbm_fit=bool(est <= HBM_BYTES),
            trace_s=round(time.time() - t0, 2),
            params=cfg.param_count(),
            active_params=cfg.active_param_count(),
        )
    except Exception as e:                       # failure IS the signal
        cell.update(status="error", error=f"{type(e).__name__}: {e}",
                    traceback=traceback.format_exc()[-6000:])
    finally:
        set_activation_sharding(None)
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{arch}__{shape_name}__{mesh_name}.json".replace("/", "_")
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(cell, f, indent=1, default=str)
    return cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="an arch, or several separated by commas")
    ap.add_argument("--shape", default=None,
                    help="a shape, or several separated by commas (run in "
                    "that order)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    archs = args.arch.split(",") if args.arch else list(ARCH_IDS)
    shapes = args.shape.split(",") if args.shape else list(SHAPES)
    pods = []
    if args.single_pod or not args.multi_pod:
        pods.append(False)
    if args.multi_pod or (args.all and not args.single_pod):
        pods.append(True)

    failures = 0
    # one mesh at a time: each has a fake group of its own size
    for mp in pods:
        mesh_name = _mesh_name(mp)
        for arch in archs:
            for shape in shapes:
                fname = os.path.join(
                    args.out, f"{arch}__{shape}__{mesh_name}.json")
                if args.skip_existing and os.path.exists(fname):
                    with open(fname) as f:
                        prev = json.load(f)
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[skip-existing] {arch} {shape} {mesh_name}")
                        continue
                cell = run_cell(arch, shape, mp, args.out)
                status = cell["status"]
                extra = ""
                if status == "ok":
                    extra = (f"flops={cell['flops']:.3e} "
                             f"coll={cell['collectives'].get('collective_bytes', 0):.3e}B "
                             f"fit={cell['hbm_fit']} "
                             f"trace={cell['trace_s']}s")
                elif status == "error":
                    extra = cell["error"][:160]
                    failures += 1
                else:
                    extra = cell.get("reason", "")
                print(f"[{status:7s}] {arch:20s} {shape:12s} {mesh_name}  "
                      f"{extra}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
