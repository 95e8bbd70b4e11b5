"""Wrapper of the flash prefill attention kernel.

For CUDA tensors it launches ``csrc/flash_attention.cu`` on the current
stream and counts the launch in ``launches``; for CPU tensors it runs the
plain version in ``ref.py``.  There is no fallback: a CUDA call the
kernel cannot take raises.

The kernel has two bodies and the wrapper picks one by the rule in
``uses_tensor_cores``: bfloat16 at Dh 64, 128 or 256 runs on the tensor
cores (``tensor_core_launches``); float32, whose tensor-core product would
be TF32, and the small Dh of the sweeps run on the CUDA cores
(``cuda_core_launches``).  ``launches`` counts both.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import launch_on
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

HEAD_DIMS = (8, 16, 32, 64, 128, 256)
TENSOR_CORE_HEAD_DIMS = (64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (CPU calls are not counted): all of
# them, and those of each body
launches = 0
tensor_core_launches = 0
cuda_core_launches = 0
# the engines' loop threads launch concurrently: every update of the
# counts holds the lock, so none is lost
_count_lock = threading.Lock()


def reset_counts() -> None:
    global launches, tensor_core_launches, cuda_core_launches
    with _count_lock:
        launches = tensor_core_launches = cuda_core_launches = 0


def _count(tensor_cores: bool) -> None:
    """Count one launch, and its body."""
    global launches, tensor_core_launches, cuda_core_launches
    with _count_lock:
        launches += 1
        if tensor_cores:
            tensor_core_launches += 1
        else:
            cuda_core_launches += 1


def uses_tensor_cores(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether a launch takes the tensor-core (mma.sync) body."""
    return dtype == torch.bfloat16 and head_dim in TENSOR_CORE_HEAD_DIMS


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
    tc = uses_tensor_cores(q.dtype, Dh)
    if tc and (q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16):
        raise ValueError("flash_attention: bf16 q, k, v must be 16-byte "
                         "aligned")
    lib = build.library()
    out = torch.empty_like(q)
    err = launch_on(q.device, lambda stream: lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
        kv_positions.data_ptr(), out.data_ptr(), B, Sq, Skv, H, Hkv, Dh,
        int(causal), int(window), DTYPES[q.dtype], int(tc), stream))
    build.check(err, "flash_attention_fwd")
    _count(tc)
    return out
