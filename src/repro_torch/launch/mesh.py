"""Production and debug meshes over ``torch.distributed``.

The counterpart of ``repro/launch/mesh.py``:

Single pod:  (16, 16) over ("data", "model")            = 256 ranks
Multi-pod :  (2, 16, 16) over ("pod", "data", "model")  = 512 ranks

The "pod" axis composes with "data" for batch/FSDP sharding, so only
gradient and weight-gather traffic crosses between pods; every TP
collective stays inside a pod.

Each mesh is a ``torch.distributed.device_mesh.DeviceMesh`` made by
``init_device_mesh`` over the default process group, which the caller
initialises first (``torch.distributed.init_process_group`` with its
address or store, world size and rank: nothing here reads a cluster's
environment).  The functions are functions so that importing this module
touches no process group.  The device type is ``"cuda"`` unless the
caller asks for ``"cpu"``; ``"cuda"`` without a card raises.

The JAX module's ``compat_make_mesh`` has no counterpart: it bridges jax
versions that differ in ``jax.make_mesh``'s arguments, and
``init_device_mesh`` has no such difference to bridge.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def _ready(device, who: str) -> str:
    """The device type asked for, once the card (where asked for) and the
    default process group are there."""
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: device 'cuda' requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    if not dist.is_initialized():
        raise RuntimeError(
            f"{who}: initialise the default process group first "
            "(torch.distributed.init_process_group)")
    return kind


def make_mesh(shape: Sequence[int], names: Sequence[str], *,
              device="cuda"):
    """A ``DeviceMesh`` of ``shape`` over the axes ``names``, on the first
    ``prod(shape)`` ranks of the default process group."""
    kind = _ready(device, "make_mesh")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_debug_mesh(num_devices: int = 8, *, device="cuda"):
    """Small ("data", "model") mesh over however many ranks the default
    process group has (at most ``num_devices``): for tests."""
    _ready(device, "make_debug_mesh")
    n = min(num_devices, dist.get_world_size())
    model = 1
    for m in (4, 2, 1):
        if n % m == 0:
            model = m
            break
    return make_mesh((n // model, model), ("data", "model"), device=device)
