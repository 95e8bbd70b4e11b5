"""Wrapper of the flash prefill attention kernel.

For CUDA tensors it launches ``csrc/flash_attention.cu`` on the current
stream and counts the launch in ``launches``; for CPU tensors it runs the
plain version in ``ref.py``; for meta tensors it gives the result's shape
and charges the kernel's work to the op-cost counter (``cost_hooks``).
There is no fallback: a CUDA call the kernel cannot take raises.

The kernel has two bodies and the wrapper picks one by the rule in
``uses_tensor_cores``: bfloat16 at Dh 64, 128 or 256 runs on the tensor
cores (``tensor_core_launches``); float32, whose tensor-core product would
be TF32, and the small Dh of the sweeps run on the CUDA cores
(``cuda_core_launches``).  ``launches`` counts both.

Training: when grad is enabled and q, k or v requires grad, the call goes
through ``FlashAttention``, an autograd ``Function``.  On the card its
forward is the same kernel, which then also writes each row's
log-sum-exp, and its backward is ``csrc/flash_attention_bwd.cu`` at Dh
64, 128 and 256, with two bodies by ``bwd_uses_tensor_cores``: bfloat16
on the tensor cores (``bwd_tensor_core_launches``), float32 on the CUDA
cores (``bwd_cuda_core_launches``); ``bwd_launches`` counts both.  Where
its dK/dV walk has too few blocks for the card, the tensor-core body
splits each group's query heads (``bwd_head_split``) and sums the splits
in a fixed order, so every call gives the same bits.  On the CPU forward
and backward are the plain versions in ``ref.py``.  Without grad the call
is the direct launch the serving path makes, with no log-sum-exp.
"""
from __future__ import annotations

import threading

import torch

from repro_torch import cost_hooks
from repro_torch.kernels import build
from repro_torch.kernels.common import launch_on, sm_count
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                    flash_attention_lse_ref,
                                                    flash_attention_ref)

HEAD_DIMS = (8, 16, 32, 64, 128, 256)
TENSOR_CORE_HEAD_DIMS = (64, 128, 256)
BWD_HEAD_DIMS = (64, 128, 256)
BWD_TENSOR_CORE_HEAD_DIMS = (64, 128, 256)
BWD_KEY_TILE = 64               # keys a block of the dK/dV walk holds
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID = 65535                # the backward grid's batch and head axes

# kernel launches since the last reset (CPU calls are not counted): all of
# them, and those of each body; the backward's likewise, a launch being
# one call (tensor cores: metadata, D, dK/dV with dQ and, split, the sum
# of the splits; CUDA cores: D, dK/dV, dQ)
launches = 0
tensor_core_launches = 0
cuda_core_launches = 0
bwd_launches = 0
bwd_tensor_core_launches = 0
bwd_cuda_core_launches = 0
# the engines' loop threads launch concurrently: every update of the
# counts holds the lock, so none is lost
_count_lock = threading.Lock()


def reset_counts() -> None:
    global launches, tensor_core_launches, cuda_core_launches
    global bwd_launches, bwd_tensor_core_launches, bwd_cuda_core_launches
    with _count_lock:
        launches = tensor_core_launches = cuda_core_launches = 0
        bwd_launches = bwd_tensor_core_launches = bwd_cuda_core_launches = 0


def _count_bwd(tensor_cores: bool) -> None:
    global bwd_launches, bwd_tensor_core_launches, bwd_cuda_core_launches
    with _count_lock:
        bwd_launches += 1
        if tensor_cores:
            bwd_tensor_core_launches += 1
        else:
            bwd_cuda_core_launches += 1


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


def bwd_uses_tensor_cores(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether a backward launch takes the tensor-core (mma.sync) body."""
    return dtype == torch.bfloat16 and head_dim in BWD_TENSOR_CORE_HEAD_DIMS


def bwd_head_split(batch: int, kv_len: int, kv_heads: int, group: int,
                   sms: int) -> int:
    """Blocks over which the tensor-core backward's dK/dV walk splits each
    group's ``group`` query heads: 1 when its (key tile, KV head, batch)
    blocks already number ``sms`` (one an SM), else the smallest divisor
    of ``group`` that brings them there, or ``group``.  Depends on the
    shapes and the card only, so a call's sums run in one order."""
    blocks = -(-kv_len // BWD_KEY_TILE) * kv_heads * batch
    for n in range(1, group + 1):
        if group % n == 0 and blocks * n >= sms:
            return n
    return group


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
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention: inputs must be contiguous")


def _launch(q, k, v, q_positions, kv_positions, causal, window, lse=None):
    """The forward kernel on q's device; ``lse``, when given, a (B,H,Sq)
    float32 buffer for each row's log-sum-exp."""
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if Dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {Dh} not in {HEAD_DIMS}")
    if q.device.type == "meta":
        # q, k, v and the positions read once, the output (and lse)
        # written once; QK^T and PV over the pairs the mask leaves
        out = torch.empty_like(q)
        cost_hooks.charge(
            4 * Dh * H * B * cost_hooks.visible_pairs(Sq, Skv, causal, window),
            _nbytes(q, k, v, q_positions, kv_positions, out, lse))
        return out
    tc = uses_tensor_cores(q.dtype, Dh)
    if tc and (q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16):
        raise ValueError("flash_attention: bf16 q, k, v must be 16-byte "
                         "aligned")
    lib = build.library()
    out = torch.empty_like(q)
    err = launch_on(q.device, lambda stream: lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
        kv_positions.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, Sq, Skv, H, Hkv, Dh,
        int(causal), int(window), DTYPES[q.dtype], int(tc), stream))
    build.check(err, "flash_attention_fwd")
    _count(tc)
    return out


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _check_bwd_shape(q, k):
    B, _, H, Dh = q.shape
    if Dh not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention backward: head_dim {Dh} not in "
                         f"{BWD_HEAD_DIMS}")
    if B > MAX_GRID or H > MAX_GRID:
        raise ValueError(f"flash_attention backward: batch {B} or heads {H} "
                         f"exceed {MAX_GRID}")


def flash_attention_bwd(q, k, v, dout, lse, *, q_positions, kv_positions,
                        causal=True, window=0):
    """The gradient of ``flash_attention`` for the output gradient
    ``dout``: (dq, dk, dv) in the dtypes of q, k, v.  ``lse`` (B,H,Sq)
    float32 is the forward's row log-sum-exp.  For CUDA tensors it launches
    ``csrc/flash_attention_bwd.cu``; for CPU tensors it runs
    ``flash_attention_bwd_ref`` (which recomputes P and needs no
    ``lse``)."""
    _check(q, k, v, q_positions, kv_positions)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, dout, q_positions=q_positions,
                                       kv_positions=kv_positions,
                                       causal=causal, window=window)
    _check_bwd_shape(q, k)
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    for name, t, shape in (("dout", dout, q.shape), ("lse", lse, (B, H, Sq))):
        if tuple(t.shape) != tuple(shape) or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"flash_attention backward: {name} must be a "
                             f"contiguous {tuple(shape)} on {q.device}")
    if dout.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError("flash_attention backward: dout in q's dtype, lse "
                        "float32")
    if q.device.type == "meta":
        # q, k, v, dout, lse and the positions read once, dq, dk, dv
        # written once; five products over the pairs the mask leaves (S
        # again, dP, dV, dK, dQ)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
            torch.empty_like(v)
        cost_hooks.charge(
            10 * Dh * H * B
            * cost_hooks.visible_pairs(Sq, Skv, causal, window),
            _nbytes(q, k, v, dout, lse, q_positions, kv_positions, dq, dk,
                    dv))
        return dq, dk, dv
    tc = bwd_uses_tensor_cores(q.dtype, Dh)
    if tc and any(t.data_ptr() % 16 for t in (q, k, v, dout)):
        raise ValueError("flash_attention backward: bf16 q, k, v, dout must "
                         "be 16-byte aligned")
    n_split = bwd_head_split(B, Skv, Hkv, H // Hkv,
                             sm_count(q.device.index)) if tc else 1
    lib = build.library()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ws = torch.empty(lib.flash_attention_bwd_workspace(
        B, Sq, Skv, H, Hkv, Dh, int(tc), n_split), dtype=torch.uint8,
        device=q.device)
    err = launch_on(q.device, lambda stream: lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), q_positions.data_ptr(), kv_positions.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ws.data_ptr(), B, Sq,
        Skv, H, Hkv, Dh, int(causal), int(window), DTYPES[q.dtype], int(tc),
        n_split, stream))
    build.check(err, "flash_attention_bwd")
    _count_bwd(tc)
    return dq, dk, dv


def flash_attention_lse(q, k, v, *, q_positions, kv_positions, causal=True,
                        window=0):
    """The forward with each row's log-sum-exp: (out, lse (B,H,Sq) f32,
    NEG_INF for a row with no valid key).  For CUDA tensors one launch of
    the forward kernel; for CPU tensors the plain versions."""
    _check(q, k, v, q_positions, kv_positions)
    kw = dict(q_positions=q_positions, kv_positions=kv_positions,
              causal=causal, window=window)
    if q.device.type == "cpu":
        return (flash_attention_ref(q, k, v, **kw),
                flash_attention_lse_ref(q, k, **kw))
    lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]),
                      dtype=torch.float32, device=q.device)
    return _launch(q, k, v, q_positions, kv_positions, causal, window,
                   lse), lse


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: the kernels on the card, the
    plain versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions, causal, window):
        kw = dict(q_positions=q_positions, kv_positions=kv_positions,
                  causal=causal, window=window)
        lse = None
        if q.device.type == "cpu":
            out = flash_attention_ref(q, k, v, **kw)
        else:
            # raise before the forward, not in the backward
            _check_bwd_shape(q, k)
            out, lse = flash_attention_lse(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, lse, q_positions, kv_positions)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse, q_positions, kv_positions = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, dout.contiguous(), lse, q_positions=q_positions,
            kv_positions=kv_positions, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, q_positions, kv_positions, causal=True,
                    window=0):
    """q: (B,Sq,H,Dh); k,v: (B,Skv,Hkv,Dh); positions int32 (-1 invalid).

    Returns attention output (B,Sq,H,Dh) in q's dtype; differentiable in
    q, k and v (``FlashAttention``) when grad is enabled and one of them
    requires it.
    """
    _check(q, k, v, q_positions, kv_positions)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, q_positions, kv_positions,
                                    bool(causal), int(window))
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, q_positions=q_positions,
                                   kv_positions=kv_positions, causal=causal,
                                   window=window)
    return _launch(q, k, v, q_positions, kv_positions, causal, window)
