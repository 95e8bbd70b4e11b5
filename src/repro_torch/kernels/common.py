"""Shared online-softmax building blocks, in plain PyTorch.

The counterpart of ``repro/kernels/common.py``; ``csrc/common.cuh`` holds
the same recurrence as device functions for the CUDA kernels.  f32
accumulation, a running row max ``m`` and normalizer ``l``, and the
``alpha = exp(m_prev - m_new)`` rescale when a chunk raises the max.

Masked-row semantics: a row whose every KV position is masked ends with
``l == 0``; ``finalize_online_softmax`` pins it to ``m = NEG_INF, l = 0``
and a zero output row, so a log-sum-exp combine treats it as empty.

``sm_count`` is the card's SM count, which the split kernels' wrappers
plan their grids by, read once per device; ``launch_on`` hands a launch
the device's current stream.
"""
from __future__ import annotations

import functools

import torch

# Finite stand-in for -inf: exp(NEG_INF - NEG_INF) stays defined (== 1)
# inside the rescale, unlike a true -inf which would produce NaN.
NEG_INF = -1e30


def qk_logits(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """Scaled q @ k^T in f32: q (R, Dh), k (C, Dh) -> logits (R, C)."""
    return (q.float() @ k.float().T) * scale


def online_softmax_update(logits, mask, v, acc, m_prev, l_prev):
    """One chunk update in f32.

    logits (R, C) raw scores; mask (1|R, C) bool, False = excluded;
    v (C, Dh); acc (R, Dh), m_prev/l_prev (R,) the running state.
    Returns the updated ``(acc, m, l)``.
    """
    logits = torch.where(mask, logits, NEG_INF)
    m_new = torch.maximum(m_prev, logits.amax(dim=-1))
    alpha = torch.exp(m_prev - m_new)
    p = torch.exp(logits - m_new[:, None])
    p = torch.where(mask, p, 0.0)
    l_new = alpha * l_prev + p.sum(dim=-1)
    acc_new = acc * alpha[:, None] + p @ v.float()
    return acc_new, m_new, l_new


def finalize_online_softmax(acc, m, l, *, normalize: bool = True):
    """End of the walk: divide by ``l`` and pin fully-masked rows.

    Returns ``(out_f32, m, l)``; rows with ``l == 0`` get ``out = 0`` and
    ``m = NEG_INF``.  With ``normalize=False`` the accumulator is returned
    unnormalized and the pin still applies.
    """
    empty = l == 0.0
    out = acc / torch.where(empty, 1.0, l)[:, None] if normalize else acc
    out = torch.where(empty[:, None], 0.0, out)
    m = torch.where(empty, NEG_INF, m)
    return out, m, l


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (cached: the
    wrappers' host time bounds a call)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_on(device: torch.device, launch):
    """Call ``launch(stream)`` with ``device``'s current CUDA stream as an
    int, making the device current only where it is not already.  The raw
    handle (read as PyTorch's generated code reads it) skips building a
    ``torch.cuda.Stream``, and both skips save host time on every call,
    which bounds a decode step."""
    index = device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        return launch(stream)
    with torch.cuda.device(device):
        return launch(stream)
