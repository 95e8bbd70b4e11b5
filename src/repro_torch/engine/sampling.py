"""Token sampling: greedy, temperature and top-k, with explicit generators.

The counterpart of ``repro/engine/sampling.py`` and of the engine's
batched sampler.  Random draws come from a ``torch.Generator`` per
request, so a request's stream is a pure function of its seed; the bits
differ from JAX's threefry streams (ROADMAP Queue 3), greedy results do
not.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

_MASKED = -1e30


def _masked_f32(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """f32 logits with the padded vocab tail masked out."""
    lg = logits.float()
    if vocab_size and vocab_size < lg.shape[-1]:
        keep = torch.arange(lg.shape[-1], device=lg.device) < vocab_size
        lg = torch.where(keep, lg, _MASKED)
    return lg


def _categorical(logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One draw per row of (R, V) logits by the Gumbel-max trick."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    return torch.argmax(logits + gumbel, dim=-1)


def sample(logits: torch.Tensor, gen: Optional[torch.Generator], *,
           temperature: float = 0.0, top_k: int = 0,
           vocab_size: int = 0) -> torch.Tensor:
    """logits: (B, Vpad) -> token ids (B,) int32.  temperature == 0 is
    greedy (``gen`` unused); ``vocab_size`` masks the padded vocab tail."""
    lg = _masked_f32(logits, vocab_size)
    if temperature == 0.0:
        return torch.argmax(lg, dim=-1).to(torch.int32)
    lg = lg / temperature
    if top_k:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, _MASKED, lg)
    return _categorical(lg, gen).to(torch.int32)


def batched_sample(logits: torch.Tensor, temps: Sequence[float],
                   gens: Sequence[Optional[torch.Generator]], *,
                   vocab_size: int) -> torch.Tensor:
    """Sample every row of a decode step's (B, Vpad) logits.

    Greedy rows take the argmax of the whole batch in one call; each row
    with ``temps[i] > 0`` draws from its own generator, so per-request
    streams do not depend on which other requests share the batch.
    Returns (B,) int32 on the logits' device.
    """
    lg = _masked_f32(logits, vocab_size)
    tokens = torch.argmax(lg, dim=-1)
    for i, t in enumerate(temps):
        if t > 0.0:
            tokens[i] = _categorical(lg[i:i + 1] / t, gens[i])[0]
    return tokens.to(torch.int32)
