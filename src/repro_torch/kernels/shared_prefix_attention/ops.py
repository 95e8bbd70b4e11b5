"""Wrappers of the shared-prefix (Hydragen-style) decode attention.

``prefix_attention`` is the kernel: one shared prefix against every query
row, an unnormalized partial ``(acc, m, l)``.  For CUDA tensors it
launches ``csrc/shared_prefix_attention.cu`` on the current stream; for
CPU tensors it runs the plain version in ``ref.py``.  The kernel has two
bodies, picked by ``uses_tensor_cores``: bfloat16 (Dh 64, 128 or 256)
runs on the tensor cores in one launch (``tensor_core_launches``);
float32, whose tensor-core product would be TF32, runs on the CUDA cores
(``cuda_core_launches``).  ``launches`` counts both.  There is no
fallback: a CUDA call the kernel cannot take raises.

``shared_prefix_attention`` is the public op of the JAX package: the
decode-attention kernel over each row's own suffix, then the prefix
kernel, which merges the suffix's result into the op's output itself;
``merge_prefix_suffix`` runs only for CPU tensors.  The prefix kernel
splits P across blocks; ``plan_chunks`` fixes the chunk from P, Dh, Hkv
and the card's SM count, never from B, so a row sums its keys in the same
order in any batch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import launch_on, sm_count
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.shared_prefix_attention.ref import (
    merge_prefix_suffix, prefix_attention_ref)

HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 16                  # query heads per KV head
MAX_ROWS = 1024                 # B*G query rows per KV head
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROW_TILE = 64                   # rows a tensor-core block holds, at most
CLUSTER = 8                     # chunks a tensor-core cluster merges

# (device index, raw stream) -> the tickets of launches on that stream
_ticket_buffers = {}

# kernel launches since the last reset (CPU calls are not counted): all of
# them, and those of each body
launches = 0
tensor_core_launches = 0
cuda_core_launches = 0


def reset_counts() -> None:
    global launches, tensor_core_launches, cuda_core_launches
    launches = tensor_core_launches = cuda_core_launches = 0


def uses_tensor_cores(dtype: torch.dtype) -> bool:
    """Whether a launch takes the tensor-core (mma.sync) body: bfloat16,
    at any of the kernel's head dims."""
    return dtype == torch.bfloat16


def sub_tile(head_dim: int) -> int:
    """Keys a block stages at a time, the quantum of a chunk: 32 at
    Dh=256, 64 below."""
    return 32 if head_dim == 256 else 64


def plan_chunks(P: int, head_dim: int, n_kv_heads: int, n_sm: int):
    """``(chunk, n_chunks)``: the keys of each block and how many chunks
    cover P.  A KV head gets whole clusters of ``CLUSTER`` chunks, as many
    as keep the grid's clusters to one for every ``2 * CLUSTER`` SMs (what
    the card ran at once, a block of the tensor-core body to an SM), at
    least one; the chunk is the fewest sub-tiles that cover P with them.
    So the plan depends on P, Dh, Hkv and the SM count alone: a row's
    order of summation is the same at every B."""
    base = sub_tile(head_dim)
    per_head = CLUSTER * max(1, n_sm // (2 * CLUSTER) // n_kv_heads)
    chunk = base * max(1, -(-P // (base * per_head)))
    return chunk, -(-P // chunk)


def _tickets(device: torch.device, stream: int, n: int):
    """The tensor-core body's tickets for launches on ``stream``: zeros,
    made once, which each launch's merging blocks leave zero again.  One
    buffer a stream, since launches on one stream run one at a time."""
    key = (device.index, stream)
    buf = _ticket_buffers.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _ticket_buffers[key] = buf
    return buf.data_ptr()


def _check(q, prefix_k, prefix_v, prefix_positions):
    """``prefix_positions`` None stands for positions 0..P-1."""
    if q.dim() != 3 or prefix_k.dim() != 3 \
            or prefix_k.shape != prefix_v.shape:
        raise ValueError(f"prefix_attention: q must be (B,H,Dh) and the "
                         f"prefix k, v (P,Hkv,Dh); got {tuple(q.shape)}, "
                         f"{tuple(prefix_k.shape)}, {tuple(prefix_v.shape)}")
    B, H, Dh = q.shape
    P, Hkv = prefix_k.shape[0], prefix_k.shape[1]
    if prefix_k.shape[2] != Dh or H % Hkv:
        raise ValueError(f"prefix_attention: incompatible q {tuple(q.shape)}"
                         f" and prefix {tuple(prefix_k.shape)}")
    if prefix_positions is not None:
        if tuple(prefix_positions.shape) != (P,):
            raise ValueError("prefix_attention: prefix_positions must be "
                             "(P,)")
        if prefix_positions.dtype != torch.int32:
            raise TypeError("prefix_attention: prefix_positions must be "
                            "int32")
    if q.dtype not in DTYPES or prefix_k.dtype != q.dtype \
            or prefix_v.dtype != q.dtype:
        raise TypeError(f"prefix_attention: q, k, v must share float32 or "
                        f"bfloat16; got {q.dtype}, {prefix_k.dtype}, "
                        f"{prefix_v.dtype}")
    tensors = [q, prefix_k, prefix_v]
    if prefix_positions is not None:
        tensors.append(prefix_positions)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("prefix_attention: inputs on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("prefix_attention: inputs must be contiguous")


def _launch(q, prefix_k, prefix_v, prefix_positions, suffix=None):
    """Launch on CUDA tensors.  ``prefix_positions`` None means positions
    0..P-1.  Without ``suffix`` returns the partial ``(acc, m, l)``; with
    the suffix pass's ``(out_s, m_s, l_s)`` returns the op's output in q's
    dtype, merged in the kernel."""
    global launches, tensor_core_launches, cuda_core_launches
    if q.device.type != "cuda":
        raise ValueError(f"prefix_attention: unsupported device {q.device}")
    B, H, Dh = q.shape
    P, Hkv = prefix_k.shape[0], prefix_k.shape[1]
    G = H // Hkv
    if Dh not in HEAD_DIMS:
        raise ValueError(f"prefix_attention: head_dim {Dh} not in "
                         f"{HEAD_DIMS}")
    if G > MAX_GROUP:
        raise ValueError(f"prefix_attention: {G} query heads per KV head "
                         f"exceed {MAX_GROUP}")
    if B * G > MAX_ROWS:
        raise ValueError(f"prefix_attention: B*G = {B * G} query rows per KV"
                         f" head exceed {MAX_ROWS}")
    if q.data_ptr() % 16 or prefix_k.data_ptr() % 16 \
            or prefix_v.data_ptr() % 16:
        raise ValueError("prefix_attention: q and the prefix k, v must be "
                         "16-byte aligned")
    tc = uses_tensor_cores(q.dtype)
    chunk, n_chunks = plan_chunks(P, Dh, Hkv, sm_count(q.device.index))
    rows = B * G
    # one allocation: the partials (acc, m, l) of the CUDA-core body's
    # chunks or, past one cluster, of the tensor-core body's clusters, then
    # the result's acc, m and l when the partial is the result (the
    # wrapper's host time, not the card's, bounds a call)
    n_clusters = -(-n_chunks // CLUSTER)
    n_split = n_clusters if tc else n_chunks
    n_part = n_split * Hkv * rows * (Dh + 2) if n_split > 1 or not tc \
        else 0
    n_out = B * H * (Dh + 2) if suffix is None else 0
    buf = torch.empty(n_part + n_out, dtype=torch.float32,
                      device=q.device) if n_part + n_out else None
    part = buf.data_ptr() if n_part else None
    n_tickets = Hkv * -(-rows // ROW_TILE) * CLUSTER \
        if tc and n_clusters > 1 else 0
    if suffix is None:
        # views by offset: fewer tensor ops than slicing and unbinding
        acc = buf.as_strided((B, H, Dh), (H * Dh, Dh, 1), n_part)
        m = buf.as_strided((B, H), (H, 1), n_part + B * H * Dh)
        l = buf.as_strided((B, H), (H, 1), n_part + B * H * (Dh + 1))
        sink = (acc.data_ptr(), m.data_ptr(), l.data_ptr(), None, None,
                None, None)
    else:
        out_s, m_s, l_s = suffix
        out = torch.empty_like(q)
        sink = (None, None, None, out_s.data_ptr(), m_s.data_ptr(),
                l_s.data_ptr(), out.data_ptr())
    kpos = None if prefix_positions is None else prefix_positions.data_ptr()
    lib = build.library()
    err = launch_on(q.device, lambda s: lib.prefix_attention_fwd(
        q.data_ptr(), prefix_k.data_ptr(), prefix_v.data_ptr(), kpos, part,
        _tickets(q.device, s, n_tickets) if n_tickets else None, *sink, B,
        P, H, Hkv, Dh, chunk, int(tc), DTYPES[q.dtype], s))
    build.check(err, "prefix_attention_fwd")
    launches += 1
    if tc:
        tensor_core_launches += 1
    else:
        cuda_core_launches += 1
    return (acc, m, l) if suffix is None else out


def prefix_attention(q, prefix_k, prefix_v, prefix_positions):
    """q: (B,H,Dh); prefix_k/v: (P,Hkv,Dh), one copy shared by every row;
    prefix_positions: (P,) int32, a key masked only where it is < 0.

    Returns the UNNORMALIZED partial ``(acc (B,H,Dh), m (B,H), l (B,H))``,
    all f32; a row with no valid key gives ``(0, NEG_INF, 0)``.
    """
    _check(q, prefix_k, prefix_v, prefix_positions)
    if q.device.type == "cpu":
        return prefix_attention_ref(q, prefix_k, prefix_v, prefix_positions)
    return _launch(q, prefix_k, prefix_v, prefix_positions)


def shared_prefix_attention(q, prefix_k, prefix_v, suffix_k, suffix_v, *,
                            q_positions, suffix_positions):
    """q: (B,H,Dh); prefix_k/v: (P,Hkv,Dh) ONE shared copy; suffix_k/v:
    (B,T,Hkv,Dh) per row with ``suffix_positions`` (B,T) int32 (-1 = empty
    slot); q_positions (B,) int32.  Returns (B,H,Dh) in q's dtype.

    Prefix slots are the absolute positions 0..P-1, all visible to every
    decode query (the prefix lies in the past); suffix keys count where
    ``0 <= kp <= q_positions``.  On the card: the decode-attention kernel
    over the suffix (``window=0``), then the prefix kernel, which merges
    the two by the JAX op's log-sum-exp rule; for CPU tensors the plain
    versions and ``merge_prefix_suffix``, which makes this
    ``ref.shared_prefix_attention_ref``.  The JAX op's Pallas block sizes
    have no counterpart: the prefix kernel cuts P into chunks by the card's
    SM count (``plan_chunks``).
    """
    if q.dim() != 3 or suffix_k.dim() != 4 or suffix_k.shape[0] != q.shape[0]:
        raise ValueError(f"shared_prefix_attention: q must be (B,H,Dh) and "
                         f"the suffix (B,T,Hkv,Dh); got {tuple(q.shape)}, "
                         f"{tuple(suffix_k.shape)}")
    if q.device.type == "cpu":
        prefix = prefix_attention(
            q, prefix_k, prefix_v,
            torch.arange(prefix_k.shape[0], dtype=torch.int32))
    else:
        _check(q, prefix_k, prefix_v, None)
    suffix = da_ops.decode_attention(
        q, suffix_k, suffix_v, q_positions=q_positions,
        kv_positions=suffix_positions, window=0, return_lse=True)
    if q.device.type == "cpu":
        return merge_prefix_suffix(prefix, suffix, q.dtype)
    return _launch(q, prefix_k, prefix_v, None, suffix)
