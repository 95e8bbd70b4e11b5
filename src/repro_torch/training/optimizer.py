"""AdamW with a cosine schedule, as plain functions on tensors.

The counterpart of ``repro/training/optimizer.py``.  Parameters, gradients
and the moments are dicts of tensors keyed by the model's parameter names
(``dict(model.named_parameters())``).  The moments are float32 whatever
the parameters' dtype, the update runs in float32 and is cast back to each
parameter's dtype, the step counter is incremented before the learning
rate is read, the gradients are clipped by their global norm with
``min(1, clip / (gnorm + 1e-9))``, and the weight decay applies to every
parameter, as in the JAX package.  ``torch.optim.AdamW`` is not used: for
bfloat16 parameters it keeps its moments and does its math in bfloat16,
which is another result.

``adamw_update`` writes the new parameters and moments IN PLACE (the JAX
function returns new trees): at qwen3-1.7b the float32 moments are 13.8
GB, and a second copy would be live until the update returned.  The step
counter and the learning rate are host tensors, so reading them costs no
device synchronisation.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0


def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio * lr``; float32
    arithmetic, as the JAX function's."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def adamw_init(params: Tensors) -> Dict:
    """Zero float32 moments beside each parameter and a step counter of 0
    (an int32 host tensor)."""
    def zeros():
        return {n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in params.items()}
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32)}


def global_norm(tensors: Tensors) -> torch.Tensor:
    """The L2 norm of every tensor together, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors.values()))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Tensors, grads: Tensors,
                 state: Dict) -> Tuple[Tensors, Dict, Tensors]:
    """One AdamW step with global-norm clipping.  Writes the parameters and
    moments in place and returns ``(params, state, metrics)``, metrics
    ``{"grad_norm", "lr"}``."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = cosine_lr(cfg, step)
    b1c = 1.0 - cfg.beta1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.beta2 ** step.to(torch.float32)
    for name, p in params.items():
        g32 = grads[name].float() * scale
        m, v = state["m"][name], state["v"][name]
        m.copy_(cfg.beta1 * m + (1 - cfg.beta1) * g32)
        v.copy_(cfg.beta2 * v + (1 - cfg.beta2) * torch.square(g32))
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        p32 = p.float()
        p.copy_((p32 - lr * (delta + cfg.weight_decay * p32)).to(p.dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
