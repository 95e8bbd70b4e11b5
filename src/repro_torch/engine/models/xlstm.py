"""The causal depthwise convolution shared with the RG-LRU blocks.

A copy of ``causal_conv1d`` / ``causal_conv1d_step`` from
``repro/engine/models/xlstm.py``, the only parts of that module the
hybrid needs; the xLSTM model itself follows in ROADMAP Queue 1 item 10.
The sequence form sums shifted elementwise products in the input's dtype,
in the JAX package's order, rather than calling ``F.conv1d``: cuDNN would
run an f32 convolution in TF32 and sum in another order.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B,S,D); w: (W,D) depthwise taps.  Output (B,S,D)."""
    W = w.shape[0]
    S = x.shape[1]
    pad = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for t in range(W):                         # W is tiny (4): unrolled
        out = out + pad[:, t:t + S] * w[t][None, None, :]
    return out


def causal_conv1d_step(x_t: torch.Tensor, buf: torch.Tensor,
                       w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_t: (B,D); buf: (B,W-1,D) previous inputs.  Returns (y_t,
    new_buf)."""
    window = torch.cat([buf, x_t[:, None, :]], dim=1)      # (B,W,D)
    y = torch.einsum("bwd,wd->bd", window, w)
    return y, window[:, 1:]
