"""KV-seq-split flash-decoding and the compressed gradient all-reduce,
over ``torch.distributed`` process groups.

The counterpart of ``repro/distribution/collectives.py``.  Where the JAX
functions run one body per shard under ``shard_map`` and merge with
``lax.pmax``/``lax.psum`` over a mesh axis, here every rank of a process
group calls the function on its own shard and the merge is an
``all_reduce`` over the group (for a mesh axis, ``mesh.get_group(axis)``).
The collectives run on the group's backend: NCCL, or gloo, which takes
CUDA tensors for ``all_reduce`` by copying them through the host.

``sharded_decode_attention`` is the distribution-level twin of the
decode kernel: the KV cache is sharded along its TIME axis over the
group; every rank runs the port's decode kernel
(``kernels/decode_attention/ops.decode_attention`` with ``return_lse``:
``decode_split_kernel`` and ``decode_combine_kernel`` on the card, the
plain version for CPU tensors) over its own slice, and the partial
(out, m, l) triples merge with the log-sum-exp combine — the same merge
the kernel uses across its chunks, lifted across ranks.  A rank whose
slice holds no valid key of a row gives out 0, l 0 and the finite m
``NEG_INF`` (the kernel's pin, as the JAX ref's), which weighs nothing;
a row with no valid key on any rank gives 0.  The kernel plans its
chunks from the slice's length, so a row sums in another order than an
unsharded call: the result equals it to rounding, not bitwise.

``compressed_psum_grads`` wires ``training/grad_compress`` into an
all-reduce: one shared scale per tensor from the all-reduced max of
``|g + err|``, int8 quantization of every rank's ``g + err`` against it
(+ error feedback), an int32 sum, and dequantization by the shared scale
over the world size, so the mean is within half a step of that scale of
the true mean.  It does not follow the JAX function, which quantizes each
pod against its own scale and dequantizes the sum by the largest
(ROADMAP Queue 3 item 12).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.training.grad_compress import (dequantize, quantize_shared,
                                                shared_scale)

Tensors = Dict[str, torch.Tensor]


def sharded_decode_attention(q, k, v, q_positions, kv_positions, *,
                             group: Optional[dist.ProcessGroup] = None,
                             window: int = 0) -> torch.Tensor:
    """q: (B,H,Dh), the same on every rank of ``group``; k, v: (B,T,Hkv,
    Dh) and kv_positions (B,T) int32, this rank's slice of the time axis;
    q_positions (B,) int32.  Returns (B,H,Dh) in q's dtype, the same on
    every rank.  Runs where the tensors are (the kernel on CUDA tensors).
    """
    if q.dim() != 3:
        raise ValueError(f"sharded_decode_attention: q must be (B,H,Dh); "
                         f"got {tuple(q.shape)}")
    out, m, l = da_ops.decode_attention(
        q, k, v, q_positions=q_positions, kv_positions=kv_positions,
        window=window, return_lse=True)
    # merge partial softmax stats across KV shards (flash-decoding)
    m_max = m.clone()
    dist.all_reduce(m_max, op=dist.ReduceOp.MAX, group=group)     # (B,H)
    w = torch.exp(m - m_max) * l
    # one sum: the weighted outputs in f32 and, last, the weights
    acc = torch.cat([out.float() * w[..., None], w[..., None]], dim=-1)
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
    num, den = acc[..., :-1], acc[..., -1]
    den = torch.where(den == 0.0, 1.0, den)
    return (num / den[..., None]).to(q.dtype)


def compressed_psum_grads(grads: Tensors, err_state: Tensors, *,
                          group: Optional[dist.ProcessGroup] = None
                          ) -> Tuple[Tensors, Tensors]:
    """int8(+EF) all-reduce of a dict of per-rank gradients over
    ``group``.  Returns (mean gradients, float32; new error state), each
    keyed as ``grads``.  Two collectives whatever the number of tensors:
    a max of every tensor's ``|g + err|`` and one int32 sum."""
    n = dist.get_world_size(group)
    names = list(grads)
    amax = torch.stack([(grads[k].float() + err_state[k]).abs().max()
                        for k in names])
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scales = shared_scale(amax)
    flat, new_err = [], {}
    for i, k in enumerate(names):
        q, new_err[k] = quantize_shared(grads[k], err_state[k], scales[i])
        flat.append(q.to(torch.int32).flatten())
    q32 = torch.cat(flat)
    dist.all_reduce(q32, op=dist.ReduceOp.SUM, group=group)
    mean, at = {}, 0
    for i, k in enumerate(names):
        size = grads[k].numel()
        mean[k] = dequantize(q32[at:at + size].view(grads[k].shape),
                             scales[i]) / n
        at += size
    return mean, new_err
