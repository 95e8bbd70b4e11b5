"""Training checkpoints: an npz shard and a manifest, committed atomically.

The counterpart of ``repro/training/checkpoint.py``, in its layout:

    <dir>/step_000000123/
        manifest.json        # step, leaf names, shapes, dtypes, extra
        shard_0.npz          # leaf_0, leaf_1, ... as numpy arrays
        COMMITTED            # written last

The checkpoint is written into a temporary directory beside the final one
and renamed onto it, so a reader never sees a partial checkpoint;
``latest_checkpoint`` takes the newest committed one.  bfloat16 is stored
as float32 (exact).  The leaves are the parameters under their
``state_dict`` names (``params/<name>``), then the optimizer's moments
(``opt/m/<name>``, ``opt/v/<name>``) and its step (``opt/step``).  Loading
places each tensor on the device and in the dtype of the matching tensor
of ``like``.

Elastic resharding (``repro/training/checkpoint.py``'s): leaves are saved
unsharded.  A DTensor leaf is gathered whole (``full_tensor``, a
collective every rank of its mesh joins) and the checkpoint is written by
rank 0 alone, in the same layout; with a process group every rank waits
for the commit.  ``load_checkpoint(..., placements=, mesh=)`` places each
parameter and its two moments on the current mesh with
``distribute_tensor`` (each rank reads the whole leaf and keeps its own
block, with no communication), so a checkpoint saved on one mesh loads
onto another.  Without placements a load is what it was.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor


def _leaves(params: Dict[str, torch.Tensor], opt_state: Dict
            ) -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every leaf, in the order they are stored."""
    out = [(f"params/{n}", t) for n, t in params.items()]
    out += [(f"opt/m/{n}", t) for n, t in opt_state["m"].items()]
    out += [(f"opt/v/{n}", t) for n, t in opt_state["v"].items()]
    out.append(("opt/step", opt_state["step"]))
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if isinstance(t, DTensor):              # gathered whole, a collective
        t = t.full_tensor()
    if t.dtype == torch.bfloat16:           # npz has no bfloat16: as f32
        t = t.float()
    return t.cpu().numpy()


def save_checkpoint(path: str, step: int, params: Dict[str, torch.Tensor],
                    opt_state: Dict, extra: Optional[Dict[str, Any]] = None
                    ) -> str:
    """Atomically write a checkpoint.  Returns the committed directory.
    Under a process group every rank calls it (a DTensor leaf is gathered
    by all its mesh's ranks); rank 0 writes."""
    final_dir = os.path.join(path, f"step_{step:09d}")
    leaves = [(n, _numpy(x), str(x.dtype).replace("torch.", ""))
              for n, x in _leaves(params, opt_state)]
    group = dist.is_initialized()
    try:
        if not group or dist.get_rank() == 0:
            _write(final_dir, step, leaves, extra)
    finally:
        if group:
            dist.barrier()
    return final_dir


def _write(final_dir: str, step: int, leaves, extra) -> None:
    parent = os.path.dirname(final_dir) or "."
    os.makedirs(parent, exist_ok=True)
    tmp_dir = tempfile.mkdtemp(dir=parent, prefix=".ckpt_tmp_")
    try:
        np.savez(os.path.join(tmp_dir, "shard_0.npz"),
                 **{f"leaf_{i}": x for i, (_, x, _) in enumerate(leaves)})
        manifest = {
            "step": step,
            "num_leaves": len(leaves),
            "keys": [n for n, _, _ in leaves],
            "shapes": [list(x.shape) for _, x, _ in leaves],
            "dtypes": [dtype for _, _, dtype in leaves],
            "extra": extra or {},
        }
        with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp_dir, "COMMITTED"), "w") as f:
            f.write("ok")
        if os.path.exists(final_dir):
            shutil.rmtree(final_dir)
        os.replace(tmp_dir, final_dir)            # atomic commit
    except BaseException:
        shutil.rmtree(tmp_dir, ignore_errors=True)
        raise


def latest_checkpoint(path: str) -> Optional[str]:
    """The newest committed ``step_*`` directory under ``path``, or None."""
    if not os.path.isdir(path):
        return None
    steps = sorted(
        d for d in os.listdir(path)
        if d.startswith("step_")
        and os.path.exists(os.path.join(path, d, "COMMITTED")))
    return os.path.join(path, steps[-1]) if steps else None


def load_checkpoint(ckpt_dir: str, like: Tuple[Dict[str, torch.Tensor], Dict],
                    placements: Optional[Dict[str, Sequence]] = None,
                    mesh=None) -> Tuple[int, Dict[str, torch.Tensor], Dict,
                                        Dict[str, Any]]:
    """Load ``(step, params, opt_state, extra)``; ``like`` is a
    ``(params, opt_state)`` pair whose names the checkpoint must hold and
    whose devices and dtypes the loaded tensors take.  With ``placements``
    (``{parameter name: DTensor placements}``, as
    ``distribution.param_shardings`` gives them for ``mesh``), each
    parameter and its moments come back as DTensors on ``mesh``; the step
    and any name without placements load as they would without."""
    if placements is not None and mesh is None:
        raise ValueError("load_checkpoint: placements need their mesh")
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    like_leaves = _leaves(*like)
    names = [n for n, _ in like_leaves]
    if manifest["keys"] != names:
        raise ValueError(f"{ckpt_dir}: the checkpoint's leaves differ from "
                         f"the model's")
    with np.load(os.path.join(ckpt_dir, "shard_0.npz")) as data:
        loaded = {n: torch.from_numpy(data[f"leaf_{i}"]).to(
                      device=ref.device, dtype=ref.dtype)
                  for i, (n, ref) in enumerate(like_leaves)}
    if placements is not None:
        for n, t in loaded.items():
            pname = n.split("/", 2)[-1] if n.startswith("opt/") \
                else n[len("params/"):]
            if n != "opt/step" and pname in placements:
                loaded[n] = distribute_tensor(t, mesh, placements[pname],
                                              src_data_rank=None)

    def part(prefix):
        return {n[len(prefix):]: t for n, t in loaded.items()
                if n.startswith(prefix)}

    opt = {"m": part("opt/m/"), "v": part("opt/v/"),
           "step": loaded["opt/step"]}
    return manifest["step"], part("params/"), opt, manifest.get("extra", {})
