"""Wrapper of the GQA flash-decode kernel over a contiguous or ring cache.

For CUDA tensors it launches ``csrc/decode_attention.cu`` on the current
stream and counts the launch in ``launches``; for CPU tensors it runs the
plain version in ``ref.py``.  There is no fallback: a CUDA call the
kernel cannot take raises.

The kernel splits T across blocks (flash-decoding).  ``plan_chunks``
fixes the chunk from T, Dh and the card's SM count, never from B, so a
row sums its keys in the same order in any batch; a call with more than
one chunk also runs the combine kernel and counts in ``split_launches``.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import launch_on, refuse_grad, sm_count
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

HEAD_DIMS = (32, 64, 128, 256)
MAX_GROUP = 16                  # query heads per KV head
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VECTOR_BYTES = 16               # K/V are loaded 16 bytes a thread

# kernel launches since the last reset (CPU calls are not counted): all,
# and those split over more than one chunk (partials, then the combine)
launches = 0
split_launches = 0
# the engines' loop threads launch concurrently: every update of the
# counts holds the lock, so none is lost
_count_lock = threading.Lock()


def reset_counts() -> None:
    global launches, split_launches
    with _count_lock:
        launches = split_launches = 0


def _count(split: bool) -> None:
    """Count one launch, and whether it was split."""
    global launches, split_launches
    with _count_lock:
        launches += 1
        if split:
            split_launches += 1


def sub_tile(head_dim: int) -> int:
    """Keys a block stages at a time: 32 at Dh=256, 64 below."""
    return 32 if head_dim == 256 else 64


def plan_chunks(T: int, head_dim: int, n_sm: int):
    """``(chunk, n_chunks)``: the keys of each block and how many chunks
    cover T.  The chunk is the fewest sub-tiles that keep the chunks at
    most one per SM, so it depends on T, Dh and the SM count alone: the
    grid is ``(B, Hkv, n_chunks)`` and a row's order of summation is the
    same at every B."""
    base = sub_tile(head_dim)
    chunk = base * max(1, -(-T // (base * n_sm)))
    return chunk, -(-T // chunk)


def _check(q, k, v, q_positions, kv_positions):
    """q is (B,H,Dh) or one token (B,1,H,Dh)."""
    if q.dim() not in (3, 4) or (q.dim() == 4 and q.shape[1] != 1) \
            or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: q must be (B,H,Dh) or "
                         f"(B,1,H,Dh) and k, v (B,T,Hkv,Dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Dh = q.shape[0], q.shape[-2], q.shape[-1]
    T, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != Dh or H % Hkv:
        raise ValueError(f"decode_attention: incompatible q {tuple(q.shape)} "
                         f"and k/v {tuple(k.shape)}")
    if q_positions.numel() != B or tuple(kv_positions.shape) != (B, T):
        raise ValueError("decode_attention: positions must be (B,) and "
                         "(B,T)")
    if q_positions.dtype != torch.int32 or kv_positions.dtype != torch.int32:
        raise TypeError("decode_attention: positions must be int32")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention: q, k, v must share float32 or "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    tensors = (q, k, v, q_positions, kv_positions)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("decode_attention: inputs on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_attention: inputs must be contiguous")


def _launch(q, k, v, q_positions, kv_positions, window):
    """Launch on q (B,H,Dh) or (B,1,H,Dh), whose memory is the same, and
    q_positions (B,) or (B,1).  Returns out at q's shape, the f32 buffer
    that holds m and l after ``n_part`` partial values, and ``n_part``."""
    refuse_grad("decode_attention", q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, H, Dh = q.shape[0], q.shape[-2], q.shape[-1]
    T, Hkv = k.shape[1], k.shape[2]
    if Dh not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {Dh} not in "
                         f"{HEAD_DIMS}")
    if H // Hkv > MAX_GROUP:
        raise ValueError(f"decode_attention: {H // Hkv} query heads per KV "
                         f"head exceed {MAX_GROUP}")
    if k.data_ptr() % VECTOR_BYTES or v.data_ptr() % VECTOR_BYTES:
        raise ValueError("decode_attention: k, v must be 16-byte aligned")
    chunk, n_chunks = plan_chunks(T, Dh, sm_count(q.device.index))
    lib = build.library()
    out = torch.empty_like(q)
    # one f32 allocation: the chunks' partials (acc, m, l) when T is
    # split, first so that acc stays 16-byte aligned, then m and l, viewed
    # only when the caller asks for them: the wrapper's host time, not the
    # card's, bounds a call
    n_part = B * H * n_chunks * (Dh + 2) if n_chunks > 1 else 0
    buf = torch.empty(n_part + 2 * B * H, dtype=torch.float32,
                      device=q.device)
    base = buf.data_ptr()
    err = launch_on(q.device, lambda stream: lib.decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
        kv_positions.data_ptr(), out.data_ptr(), base + 4 * n_part,
        base + 4 * (n_part + B * H), base if n_part else None, B, T, H, Hkv,
        Dh, int(window), chunk, DTYPES[q.dtype], stream))
    build.check(err, "decode_attention_fwd")
    _count(n_chunks > 1)
    return out, buf, n_part


def decode_attention(q, k, v, *, q_positions, kv_positions, window=0,
                     return_lse=False):
    """q: (B,1,H,Dh) or (B,H,Dh); k,v: (B,T,Hkv,Dh); q_positions (B,) or
    (B,1) int32; kv_positions (B,T) int32, -1 = empty slot.

    Returns the output at q's rank in q's dtype (plus ``m, l`` (B,H) f32
    with ``return_lse``).
    """
    _check(q, k, v, q_positions, kv_positions)
    B, H = q.shape[0], q.shape[-2]
    if q.device.type == "cpu":
        out, m, l = decode_attention_ref(
            q.reshape(B, H, q.shape[-1]), k, v, q_positions=q_positions,
            kv_positions=kv_positions, window=window, return_lse=True)
        out = out.reshape(q.shape)
        return (out, m, l) if return_lse else out
    out, buf, n_part = _launch(q, k, v, q_positions, kv_positions, window)
    if not return_lse:
        return out
    m, l = buf[n_part:].view(2, B, H).unbind(0)
    return out, m, l
