"""Plain PyTorch RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t.

The counterpart of ``repro/kernels/rglru_scan/ref.py`` (a ``lax.scan``
there, a Python loop over time here) and the plain version the CUDA
kernel (``csrc/rglru_scan.cu``) is held against, bitwise: each step is a
multiply, then an add, both rounded, as the kernel rounds them.
"""
from __future__ import annotations

import torch


def linear_scan_ref(a, b, h0=None):
    """a, b: (B,S,D) f32 -> h (B,S,D) f32, scanned from ``h0`` (B,D) or
    zeros."""
    B, S, D = a.shape
    h = torch.zeros((B, D), dtype=a.dtype, device=a.device) \
        if h0 is None else h0
    out = torch.empty_like(a)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out
