"""Wrapper of the flash prefill attention kernel.

For CUDA tensors it launches ``csrc/flash_attention.cu`` on the current
stream and counts the launch in ``launches``; for CPU tensors it runs the
plain version in ``ref.py``.  There is no fallback: a CUDA call the
kernel cannot take raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

HEAD_DIMS = (8, 16, 32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (CPU calls are not counted)
launches = 0


def _check(q, k, v, q_positions, kv_positions):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q must be (B,Sq,H,Dh) and k, v "
                         f"(B,Skv,Hkv,Dh); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != Dh or H % Hkv:
        raise ValueError(f"flash_attention: incompatible q {tuple(q.shape)} "
                         f"and k/v {tuple(k.shape)}")
    if tuple(q_positions.shape) != (B, Sq) \
            or tuple(kv_positions.shape) != (B, Skv):
        raise ValueError("flash_attention: positions must be (B,Sq) and "
                         "(B,Skv)")
    if q_positions.dtype != torch.int32 or kv_positions.dtype != torch.int32:
        raise TypeError("flash_attention: positions must be int32")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share float32 or "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    tensors = (q, k, v, q_positions, kv_positions)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("flash_attention: inputs on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention: inputs must be contiguous")


def flash_attention(q, k, v, *, q_positions, kv_positions, causal=True,
                    window=0):
    """q: (B,Sq,H,Dh); k,v: (B,Skv,Hkv,Dh); positions int32 (-1 invalid).

    Returns attention output (B,Sq,H,Dh) in q's dtype.
    """
    global launches
    _check(q, k, v, q_positions, kv_positions)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, q_positions=q_positions,
                                   kv_positions=kv_positions, causal=causal,
                                   window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if Dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {Dh} not in {HEAD_DIMS}")
    lib = build.library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
            kv_positions.data_ptr(), out.data_ptr(), B, Sq, Skv, H, Hkv, Dh,
            int(causal), int(window), DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "flash_attention_fwd")
    launches += 1
    return out
