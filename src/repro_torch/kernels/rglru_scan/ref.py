"""Plain PyTorch RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t, and
its backward.

``linear_scan_ref`` is the counterpart of ``repro/kernels/rglru_scan/ref.py``
(a ``lax.scan`` there, a Python loop over time here) and the plain version
the CUDA kernel (``csrc/rglru_scan.cu``) is held against, bitwise: each
step is a multiply, then an add, both rounded, as the kernel rounds them.

``linear_scan_bwd_ref`` is its gradient, the plain version of the CUDA
backward: the adjoint ``g_t = dh_t + a_{t+1} g_{t+1}`` (a zero past the
end) is the same recurrence run backwards in time, then ``db = g`` and
``da_t = g_t h_{t-1}``.  It walks time from the last step in the kernel's
order and rounding, so the kernel equals it bitwise
(``tests/test_torch_cuda.py``); it also equals ``linear_scan_ref`` over
the time-reversed ``(a shifted by one, dh)`` bit for bit
(``tests/test_torch_backward_tiles.py``).

Both walk time through ``cost_hooks.steps``: ``range`` outside the op-cost
counter, one step counted S times under it.
"""
from __future__ import annotations

import torch

from repro_torch.cost_hooks import steps


def linear_scan_ref(a, b, h0=None):
    """a, b: (B,S,D) f32 -> h (B,S,D) f32, scanned from ``h0`` (B,D) or
    zeros."""
    B, S, D = a.shape
    h = torch.zeros((B, D), dtype=a.dtype, device=a.device) \
        if h0 is None else h0
    out = torch.empty_like(a)
    for t in steps(S):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def linear_scan_bwd_ref(a, h, dh):
    """The gradient of ``h = linear_scan_ref(a, b)`` (zero start) for the
    output gradient ``dh``: (da, db), each (B,S,D) f32.  Each step is a
    multiply, then an add (``g = a_{t+1} * g + dh_t``), and ``da`` one
    multiply, as the kernel rounds them."""
    B, S, D = a.shape
    g = torch.zeros((B, D), dtype=a.dtype, device=a.device)
    a_next = torch.zeros_like(g)
    da, db = torch.empty_like(a), torch.empty_like(a)
    for i in steps(S):
        t = S - 1 - i
        g = a_next * g + dh[:, t]
        db[:, t] = g
        da[:, t] = g * (h[:, t - 1] if t else torch.zeros_like(g))
        a_next = a[:, t]
    return da, db
