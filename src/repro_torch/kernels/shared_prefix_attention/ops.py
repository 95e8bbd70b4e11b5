"""Wrappers of the shared-prefix (Hydragen-style) decode attention.

``prefix_attention`` is the kernel: one shared prefix against every query
row, an unnormalized partial ``(acc, m, l)``.  For CUDA tensors it
launches ``csrc/shared_prefix_attention.cu`` on the current stream and
counts the launch in ``launches``; for CPU tensors it runs the plain
version in ``ref.py``.  ``shared_prefix_attention`` is the public op of
the JAX package: the prefix kernel, the decode-attention kernel over each
row's own suffix, and the log-sum-exp merge.  There is no fallback: a
CUDA call the kernels cannot take raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import sm_count
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.shared_prefix_attention.ref import (
    merge_prefix_suffix, prefix_attention_ref)

HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 16                  # query heads per KV head
MAX_ROWS = 1024                 # B*G query rows per KV head
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK_QUANTUM = 64              # keys: a P chunk is a multiple of this
WARPS = 8                       # a block holds 8 warps' query rows

# kernel launches since the last reset (CPU calls are not counted)
launches = 0


def _check(q, prefix_k, prefix_v, prefix_positions):
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
    if tuple(prefix_positions.shape) != (P,):
        raise ValueError("prefix_attention: prefix_positions must be (P,)")
    if prefix_positions.dtype != torch.int32:
        raise TypeError("prefix_attention: prefix_positions must be int32")
    if q.dtype not in DTYPES or prefix_k.dtype != q.dtype \
            or prefix_v.dtype != q.dtype:
        raise TypeError(f"prefix_attention: q, k, v must share float32 or "
                        f"bfloat16; got {q.dtype}, {prefix_k.dtype}, "
                        f"{prefix_v.dtype}")
    tensors = (q, prefix_k, prefix_v, prefix_positions)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("prefix_attention: inputs on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("prefix_attention: inputs must be contiguous")


def split(P: int, Hkv: int, rows: int, n_sm: int):
    """How the kernel cuts its work: ``(rows_per_warp, chunk)``.

    A block holds 8 warps of 1, 2 or 4 query rows, the fewest tiles that
    cover the ``rows`` (B*G) of a KV head; P is cut into chunks (multiples
    of 64 keys) so that the grid (Hkv, chunks, row tiles) holds about two
    blocks for each of the card's ``n_sm`` SMs.
    """
    rpw = 1 if rows <= WARPS else 2 if rows <= 2 * WARPS else 4
    tiles = -(-rows // (WARPS * rpw))
    want = max(1, -(-2 * n_sm // (Hkv * tiles)))
    chunk = CHUNK_QUANTUM * max(1, -(-P // (want * CHUNK_QUANTUM)))
    return rpw, chunk


def _launch(q, prefix_k, prefix_v, prefix_positions):
    global launches
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
    if prefix_k.data_ptr() % 16 or prefix_v.data_ptr() % 16:
        raise ValueError("prefix_attention: prefix k, v must be 16-byte "
                         "aligned")
    rpw, chunk = split(P, Hkv, B * G, sm_count(q.device.index))
    n_part = -(-P // chunk) * Hkv * B * G
    lib = build.library()
    # one allocation for the chunks' partials (acc, m, l), one for the
    # outputs: the wrapper's host time, not the card's, bounds a call
    part = torch.empty(n_part * (Dh + 2), dtype=torch.float32,
                       device=q.device)
    outs = torch.empty(B * H * (Dh + 2), dtype=torch.float32,
                       device=q.device)
    acc = outs[:B * H * Dh].view(B, H, Dh)
    m = outs[B * H * Dh:B * H * (Dh + 1)].view(B, H)
    l = outs[B * H * (Dh + 1):].view(B, H)
    ptr = part.data_ptr()
    with torch.cuda.device(q.device):
        err = lib.prefix_attention_fwd(
            q.data_ptr(), prefix_k.data_ptr(), prefix_v.data_ptr(),
            prefix_positions.data_ptr(), ptr, ptr + 4 * n_part * Dh,
            ptr + 4 * n_part * (Dh + 1), acc.data_ptr(), m.data_ptr(),
            l.data_ptr(), B, P, H, Hkv, Dh, chunk, rpw, DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "prefix_attention_fwd")
    launches += 1
    return acc, m, l


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
    ``0 <= kp <= q_positions``.  The prefix kernel, the decode-attention
    kernel over the suffix (``window=0``), then the log-sum-exp merge in
    plain torch, as the JAX op merges outside its kernels; for CPU tensors
    both wrappers take their plain versions, which makes this
    ``ref.shared_prefix_attention_ref``.  The JAX op's Pallas block sizes
    have no counterpart: the prefix kernel cuts P into chunks by the card's
    SM count (``split``).
    """
    if q.dim() != 3 or suffix_k.dim() != 4 or suffix_k.shape[0] != q.shape[0]:
        raise ValueError(f"shared_prefix_attention: q must be (B,H,Dh) and "
                         f"the suffix (B,T,Hkv,Dh); got {tuple(q.shape)}, "
                         f"{tuple(suffix_k.shape)}")
    P = prefix_k.shape[0]
    prefix = prefix_attention(
        q, prefix_k, prefix_v,
        torch.arange(P, dtype=torch.int32, device=q.device))
    suffix = da_ops.decode_attention(
        q, suffix_k, suffix_v, q_positions=q_positions,
        kv_positions=suffix_positions, window=0, return_lse=True)
    return merge_prefix_suffix(prefix, suffix, q.dtype)
