"""Plain PyTorch RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t, and
its backward.

``linear_scan_ref`` is the counterpart of ``repro/kernels/rglru_scan/ref.py``
(a ``lax.scan`` there, a Python loop over time here) and the plain version
the CUDA kernel (``csrc/rglru_scan.cu``) is held against, bitwise: each
step is a multiply, then an add, both rounded, as the kernel rounds them.

``linear_scan_bwd_ref`` is its gradient: the adjoint ``g_t = dh_t +
a_{t+1} g_{t+1}`` is the same recurrence run backwards in time, so it is
``linear_scan_ref`` over the time-reversed ``(a shifted by one, dh)``; then
``db = g`` and ``da = g * h_{t-1}``.  The CUDA backward runs the same
reversal through the forward kernel.
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


def scan_bwd_inputs(a, dh):
    """The time-reversed ``(a_{t+1}, dh_t)`` (a zero past the end) whose
    forward scan is the reversed adjoint."""
    a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
    return a_next.flip(1), dh.flip(1)


def scan_bwd_outputs(g_rev, h):
    """(da, db) from the reversed adjoint and the forward's h."""
    g = g_rev.flip(1)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    return g * h_prev, g


def linear_scan_bwd_ref(a, h, dh):
    """The gradient of ``h = linear_scan_ref(a, b)`` (zero start) for the
    output gradient ``dh``: (da, db), each (B,S,D) f32."""
    return scan_bwd_outputs(linear_scan_ref(*scan_bwd_inputs(a, dh)), h)
