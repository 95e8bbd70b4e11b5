"""Wrapper of the RG-LRU linear-recurrence scan kernel.

For CUDA tensors it launches ``csrc/rglru_scan.cu`` on the current stream
and counts the launch in ``launches``; for CPU tensors it runs the plain
version in ``ref.py``.  There is no fallback: a CUDA call the kernel
cannot take raises.

Training: when grad is enabled and a or b requires grad, the call goes
through ``LinearScan``, an autograd ``Function``.  Its backward is the same
recurrence backwards in time (``ref.linear_scan_bwd_ref``): on the card one
launch of the backward kernel, which reads a, h and dh in place and writes
da and db, counted in ``bwd_launches``; on the CPU the plain version.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import launch_on
from repro_torch.kernels.rglru_scan.ref import (linear_scan_bwd_ref,
                                               linear_scan_ref)

MAX_BATCH = 65535               # the grid's second dimension

# kernel launches since the last reset (CPU calls are not counted): the
# forward's, and the backward's
launches = 0
bwd_launches = 0
# the engines' loop threads launch concurrently: every update of the
# counts holds the lock, so none is lost
_count_lock = threading.Lock()


def reset_counts() -> None:
    global launches, bwd_launches
    with _count_lock:
        launches = bwd_launches = 0


def _count(backward: bool = False) -> None:
    """Count one launch."""
    global launches, bwd_launches
    with _count_lock:
        if backward:
            bwd_launches += 1
        else:
            launches += 1


def _check(a, b):
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"linear_scan: a and b must be (B,S,D) alike; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"linear_scan: a and b must be float32; got "
                        f"{a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError("linear_scan: inputs on different devices")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"linear_scan: unsupported device {a.device}")


def _launch(a, b):
    """The kernel over contiguous CUDA (B,S,D) float32 a, b."""
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("linear_scan: inputs must be contiguous")
    B, S, D = a.shape
    if B > MAX_BATCH:
        raise ValueError(f"linear_scan: batch {B} exceeds {MAX_BATCH}")
    lib = build.library()
    h = torch.empty_like(a)
    err = launch_on(a.device, lambda stream: lib.linear_scan_fwd(
        a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, D, stream))
    build.check(err, "linear_scan_fwd")
    _count()
    return h


def linear_scan_bwd(a, h, dh):
    """The gradient of ``h = linear_scan(a, b)`` for ``dh``: (da, db).  For
    CUDA tensors one launch of the backward kernel; for CPU tensors
    ``linear_scan_bwd_ref``."""
    _check(a, dh)
    _check(a, h)
    if a.device.type == "cpu":
        return linear_scan_bwd_ref(a, h, dh)
    if not all(t.is_contiguous() for t in (a, h, dh)):
        raise ValueError("linear_scan backward: inputs must be contiguous")
    B, S, D = a.shape
    if B > MAX_BATCH:
        raise ValueError(f"linear_scan: batch {B} exceeds {MAX_BATCH}")
    lib = build.library()
    da, db = torch.empty_like(a), torch.empty_like(a)
    err = launch_on(a.device, lambda stream: lib.linear_scan_bwd(
        a.data_ptr(), h.data_ptr(), dh.data_ptr(), da.data_ptr(),
        db.data_ptr(), B, S, D, stream))
    build.check(err, "linear_scan_bwd")
    _count(backward=True)
    return da, db


class LinearScan(torch.autograd.Function):
    """The scan with its gradient: the kernel on the card, the plain
    versions on the CPU."""

    @staticmethod
    def forward(ctx, a, b):
        h = linear_scan_ref(a, b) if a.device.type == "cpu" \
            else _launch(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        return linear_scan_bwd(a, h, dh.contiguous())


def linear_scan(a, b):
    """a, b: (B,S,D) float32 -> h (B,S,D) float32 of h_t = a_t * h_{t-1}
    + b_t from a zero state; differentiable (``LinearScan``) when grad is
    enabled and a or b requires it."""
    _check(a, b)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return LinearScan.apply(a, b)
    if a.device.type == "cpu":
        return linear_scan_ref(a, b)
    return _launch(a, b)
