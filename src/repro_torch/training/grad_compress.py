"""Int8 gradient compression with error feedback.

The counterpart of ``repro/training/grad_compress.py``, over dicts of
tensors: symmetric per-tensor int8 quantization of ``g + err``, whose
residual feeds the next step (error feedback keeps the scheme unbiased in
the long run).  ``torch.round`` rounds half to even, as ``jnp.round``
does, so the int8 values and scales equal the JAX package's.

``quantize_error_feedback`` quantizes against the tensor's own scale.
The compressed all-reduce (``distribution.collectives.
compressed_psum_grads``) quantizes every rank's ``g + err`` against one
scale shared by all ranks (``shared_scale`` of the all-reduced max of
``|g + err|``) with ``quantize_shared``, so the int32 sum of the int8
values dequantizes by that one scale.  It does not follow the JAX
package's recipe, which quantizes each pod against its own scale and
dequantizes the sum by the largest (ROADMAP Queue 3 item 12).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


def shared_scale(amax: torch.Tensor) -> torch.Tensor:
    """The int8 scale of a tensor whose largest magnitude is ``amax``."""
    return torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))


def _to_int8(g32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization.  Returns (q, scale)."""
    g32 = g.float()
    scale = shared_scale(torch.max(torch.abs(g32)))
    return _to_int8(g32, scale), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def quantize_error_feedback(g: torch.Tensor, err: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Quantize ``g + err``; the new residual feeds the next step."""
    corrected = g.float() + err
    q, scale = quantize(corrected)
    return q, scale, corrected - dequantize(q, scale)


def quantize_shared(g: torch.Tensor, err: torch.Tensor,
                    scale: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``g + err`` against ``scale``, a scale shared with other
    ranks (at least ``max|g + err| / 127``, so nothing clips).  Returns
    (q, the new residual against that scale)."""
    corrected = g.float() + err
    q = _to_int8(corrected, scale)
    return q, corrected - dequantize(q, scale)


def init_error_state(grads: Tensors) -> Tensors:
    return {n: torch.zeros_like(g, dtype=torch.float32)
            for n, g in grads.items()}


def compress_tree(grads: Tensors, err_state: Tensors
                  ) -> Tuple[Tensors, Tensors, Tensors]:
    """Quantize every gradient with error feedback.  Returns (int8 q,
    scales, new error state), each keyed as ``grads``."""
    qs, scales, errs = {}, {}, {}
    for name, g in grads.items():
        qs[name], scales[name], errs[name] = quantize_error_feedback(
            g, err_state[name])
    return qs, scales, errs


def decompress_tree(q_tree: Tensors, scale_tree: Tensors) -> Tensors:
    return {n: dequantize(q, scale_tree[n]) for n, q in q_tree.items()}
