"""Wrapper of the RG-LRU linear-recurrence scan kernel.

For CUDA tensors it launches ``csrc/rglru_scan.cu`` on the current stream
and counts the launch in ``launches``; for CPU tensors it runs the plain
version in ``ref.py``.  There is no fallback: a CUDA call the kernel
cannot take raises.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import launch_on
from repro_torch.kernels.rglru_scan.ref import linear_scan_ref

MAX_BATCH = 65535               # the grid's second dimension

# kernel launches since the last reset (CPU calls are not counted)
launches = 0
# the engines' loop threads launch concurrently: every update of the
# counts holds the lock, so none is lost
_count_lock = threading.Lock()


def reset_counts() -> None:
    global launches
    with _count_lock:
        launches = 0


def _count() -> None:
    """Count one launch."""
    global launches
    with _count_lock:
        launches += 1


def linear_scan(a, b):
    """a, b: (B,S,D) float32 -> h (B,S,D) float32 of h_t = a_t * h_{t-1}
    + b_t from a zero state."""
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"linear_scan: a and b must be (B,S,D) alike; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"linear_scan: a and b must be float32; got "
                        f"{a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError("linear_scan: inputs on different devices")
    if a.device.type == "cpu":
        return linear_scan_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"linear_scan: unsupported device {a.device}")
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
