"""Rank bodies of ``tests/test_torch_distribution.py``: each runs in a
process spawned by the test (``torch.multiprocessing``, spawn start
method) and joins a gloo group over a ``FileStore``.  This module imports
no JAX, so a rank starts on torch alone.  A rank reads its inputs from the
test's ``inputs.pt`` and writes what it saw to ``<task>_<rank>.pt``."""
import os

import torch
import torch.distributed as dist


def run(rank, world, store_path, task, work_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        inp = torch.load(os.path.join(work_dir, "inputs.pt"))
        res = TASKS[task](rank, world, inp, work_dir)
        torch.save(res, os.path.join(work_dir, f"{task}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _slice(t, rank, world, dim=1):
    return t.chunk(world, dim=dim)[rank].contiguous()


def four(rank, world, inp, work_dir):
    """The sharded decode, placements on a (2,2,1) mesh, the compressed
    all-reduce and a checkpoint saved from a (2,2) mesh."""
    from repro_torch.configs import get_smoke
    from repro_torch.distribution.collectives import (
        compressed_psum_grads, sharded_decode_attention)
    from repro_torch.distribution.sharding import (param_shardings,
                                                   to_placements)
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.launch.mesh import make_debug_mesh, make_mesh
    from repro_torch.training.checkpoint import save_checkpoint
    from repro_torch.training.grad_compress import init_error_state
    from torch.distributed.tensor import distribute_tensor
    res = {}

    # sharded decode: rank r holds the r-th contiguous quarter of T
    d = inp["decode"]
    da_ops.reset_counts()
    for window in d["windows"]:
        res[f"decode_w{window}"] = sharded_decode_attention(
            d["q"], _slice(d["k"], rank, world), _slice(d["v"], rank, world),
            d["qp"], _slice(d["kp"], rank, world), window=window)
    res["decode_launches"] = da_ops.launches          # CPU: none

    # placements on a real ("pod", "data", "model") mesh
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), device="cpu")
    res["coords"] = tuple(mesh.get_coordinate())
    for i, spec in enumerate(inp["specs"]):
        dt = distribute_tensor(inp["blocks_x"], mesh,
                               to_placements(spec, mesh), src_data_rank=None)
        res[f"block_{i}"] = dt.to_local().clone()
    res["debug_mesh"] = tuple(make_debug_mesh(device="cpu").shape)

    # the compressed all-reduce, two steps of error feedback
    grads = inp["grads"][rank]
    err = init_error_state(grads)
    for step in (1, 2):
        mean, err = compressed_psum_grads(grads, err)
        res[f"mean_{step}"], res[f"err_{step}"] = mean, err

    # a train state saved from a (2,2) mesh
    ck = inp["ckpt"]
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    pl = param_shardings(ck["params"], mesh, cfg=get_smoke(ck["arch"]))

    def place(tensors):
        return {n: distribute_tensor(t, mesh, pl[n], src_data_rank=None)
                for n, t in tensors.items()}

    opt = {"m": place(ck["opt"]["m"]), "v": place(ck["opt"]["v"]),
           "step": ck["opt"]["step"]}
    res["saved"] = save_checkpoint(os.path.join(work_dir, "ckpt"), 3,
                                   place(ck["params"]), opt,
                                   extra={"mesh": [2, 2]})
    return res


def two(rank, world, inp, work_dir):
    """The (2,2) mesh's checkpoint loaded onto a (1,2) mesh, and the
    compressed all-reduce at the two pods of ROADMAP Queue 3 item 12."""
    from repro_torch.configs import get_smoke
    from repro_torch.distribution.collectives import compressed_psum_grads
    from repro_torch.distribution.sharding import param_shardings
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training.checkpoint import (latest_checkpoint,
                                                 load_checkpoint)
    from repro_torch.training.grad_compress import init_error_state
    ck = inp["ckpt"]
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    pl = param_shardings(ck["params"], mesh, cfg=get_smoke(ck["arch"]))
    step, params, opt, extra = load_checkpoint(
        latest_checkpoint(os.path.join(work_dir, "ckpt")),
        (ck["params"], ck["opt"]), placements=pl, mesh=mesh)
    res = {"step": step, "extra": extra, "coords": tuple(
        mesh.get_coordinate()), "opt_step": opt["step"]}
    for kind, tensors in (("params", params), ("m", opt["m"]),
                          ("v", opt["v"])):
        res[kind] = {n: (t.to_local().clone(), t.full_tensor(),
                         tuple(t.placements)) for n, t in tensors.items()}
    g = {"w": inp["pods"][rank]}
    res["pods_mean"], _ = compressed_psum_grads(g, init_error_state(g))
    return res


TASKS = {"four": four, "two": two}
