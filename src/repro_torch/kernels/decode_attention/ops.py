"""Wrapper of the GQA flash-decode kernel over a contiguous or ring cache.

For CUDA tensors it launches ``csrc/decode_attention.cu`` on the current
stream and counts the launch in ``launches``; for CPU tensors it runs the
plain version in ``ref.py``.  There is no fallback: a CUDA call the
kernel cannot take raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

HEAD_DIMS = (32, 64, 128, 256)
MAX_GROUP = 16                  # query heads per KV head: one warp each
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (CPU calls are not counted)
launches = 0


def _check(q, k, v, q_positions, kv_positions):
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: q must be (B,H,Dh) and k, v "
                         f"(B,T,Hkv,Dh); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Dh = q.shape
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
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, H, Dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if Dh not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {Dh} not in "
                         f"{HEAD_DIMS}")
    if H // Hkv > MAX_GROUP:
        raise ValueError(f"decode_attention: {H // Hkv} query heads per KV "
                         f"head exceed {MAX_GROUP}")
    lib = build.library()
    out = torch.empty_like(q)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
            kv_positions.data_ptr(), out.data_ptr(), m.data_ptr(),
            l.data_ptr(), B, T, H, Hkv, Dh, int(window), DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "decode_attention_fwd")
    launches += 1
    return out, m, l


def decode_attention(q, k, v, *, q_positions, kv_positions, window=0,
                     return_lse=False):
    """q: (B,1,H,Dh) or (B,H,Dh); k,v: (B,T,Hkv,Dh); q_positions (B,) or
    (B,1) int32; kv_positions (B,T) int32, -1 = empty slot.

    Returns the output at q's rank in q's dtype (plus ``m, l`` (B,H) f32
    with ``return_lse``).
    """
    squeeze = q.dim() == 4
    if squeeze:
        if q.shape[1] != 1:
            raise ValueError("decode_attention: q must hold one token")
        q = q[:, 0]
    _check(q, k, v, q_positions, kv_positions)
    if q.device.type == "cpu":
        out, m, l = decode_attention_ref(
            q, k, v, q_positions=q_positions, kv_positions=kv_positions,
            window=window, return_lse=True)
    else:
        out, m, l = _launch(q, k, v, q_positions.reshape(-1), kv_positions,
                            window)
    if squeeze:
        out = out[:, None]
    return (out, m, l) if return_lse else out
