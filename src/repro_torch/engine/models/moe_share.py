"""DeepSeek-V2's expert layer: group-limited routing over every expert, a
dropless dispatch, and only the held experts' part computed.

``group_limited_topk`` is the published ``group_limited_greedy`` gate:
the softmax over all ``E`` router outputs, the ``n_group`` groups of
``E / n_group`` experts each scored by its best probability, the top
``topk_group`` groups kept, the top-k experts among them chosen, their
probabilities (renormalized only with ``norm_topk_prob``) times
``routed_scaling_factor``.  On one card of a deployment that spreads a
layer's experts over several, the layer holds the contiguous experts
``held_start .. held_start + held_count - 1`` (``RoutingConfig``) and
computes their part of the result: the token-expert slots routed to a
held expert, every one of them (no capacity, nothing dropped), plus the
shared experts on every token.  What the other cards' experts add is
left out, here and in the reference alike (the model-configs guide's
expert share); the shares of all cards, with the shared experts counted
once, add up to the whole layer.

The dispatch makes no host sync: the slots are sorted by held expert
(the rest after them), each held expert's slots are one group of
``torch._grouped_mm``, whose group ends (``offs``) stay on the device,
and the sorted results are gathered back to their slots.  No one-hot
cumsum and no accumulating ``index_put_``: both were measured slow on the
card (ROADMAP Queue 4 item 20).  The rows past the last held slot are
left unwritten by the grouped product and masked out of the combine.
``slots_held``, where given, accumulates the held slots on the device.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import MoEConfig, RoutingConfig
from repro_torch.engine.models import layers as L


def held_range(moe: MoEConfig, routing: RoutingConfig):
    """(first held expert, experts held)."""
    n = routing.held_count or moe.num_experts
    if routing.held_start < 0 or routing.held_start + n > moe.num_experts:
        raise ValueError(f"held experts {routing.held_start}..+{n} outside "
                         f"the {moe.num_experts} routed")
    return routing.held_start, n


class ExpertShare(nn.Module):
    """One layer's router (all experts, float32), its held experts
    stacked on a leading axis, and its shared experts; indexed by leaf
    name like ``moe.MoE``."""

    def __init__(self, d_model: int, moe: MoEConfig, routing: RoutingConfig,
                 dtype, device):
        super().__init__()
        _, n_held = held_range(moe, routing)
        fe = moe.d_ff_expert

        def param(*shape, dt=dtype):
            return L.param(*shape, dtype=dt, device=device)

        self.router = param(d_model, moe.num_experts, dt=torch.float32)
        self.w_gate = param(n_held, d_model, fe)
        self.w_up = param(n_held, d_model, fe)
        self.w_down = param(n_held, fe, d_model)
        if moe.num_shared_experts:
            fs = moe.num_shared_experts * fe
            self.shared = L.param_dict({"w_gate": (d_model, fs),
                                        "w_up": (d_model, fs),
                                        "w_down": (fs, d_model)},
                                       dtype, device)

    def __getitem__(self, name: str):
        return getattr(self, name)


def group_limited_topk(x: torch.Tensor, router: torch.Tensor,
                       moe: MoEConfig, routing: RoutingConfig):
    """x (N, D) -> (weights (N, K) float32, experts (N, K) int64)."""
    N = x.shape[0]
    E, G = moe.num_experts, routing.n_group
    probs = torch.softmax(x.float() @ router.float(), dim=-1)   # (N, E)
    grouped = probs.view(N, G, E // G)
    best = torch.topk(grouped.amax(dim=-1), routing.topk_group,
                      dim=-1).indices                          # (N, kg)
    keep = torch.zeros((N, G), dtype=torch.bool, device=x.device)
    keep.scatter_(1, best, True)
    masked = grouped.masked_fill(~keep[:, :, None], 0.0).view(N, E)
    w, idx = torch.topk(masked, moe.top_k, dim=-1)
    if routing.norm_topk_prob:
        w = w / w.sum(-1, keepdim=True).clamp_min(1e-20)
    return w * routing.routed_scaling_factor, idx


def share_ffn(x: torch.Tensor, p, moe: MoEConfig, routing: RoutingConfig,
              valid: Optional[torch.Tensor] = None,
              slots_held: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, S, D) -> the held experts' part plus the shared experts,
    (B, S, D).  ``valid`` (B, S) bool leaves padding rows out of the
    routed products (their result is the shared experts' alone)."""
    B, S, D = x.shape
    N, K = B * S, moe.top_k
    e0, n_held = held_range(moe, routing)
    xf = x.reshape(N, D)
    w, idx = group_limited_topk(xf, p["router"], moe, routing)
    local = idx - e0
    held = (local >= 0) & (local < n_held)                     # (N, K)
    if valid is not None:
        held &= valid.reshape(N, 1)
    key = torch.where(held, local, n_held).reshape(N * K)
    sorted_key, order = torch.sort(key, stable=True)
    ends = torch.searchsorted(
        sorted_key, torch.arange(n_held, device=x.device, dtype=key.dtype),
        right=True).to(torch.int32)                            # (n_held,)
    if slots_held is not None:
        slots_held.add_(ends[-1])
    rows = xf[order // K]                                      # (N*K, D)
    h = F.silu(torch._grouped_mm(rows, p["w_gate"], offs=ends)) \
        * torch._grouped_mm(rows, p["w_up"], offs=ends)
    out = torch._grouped_mm(h, p["w_down"], offs=ends)
    back = torch.empty_like(order)
    back[order] = torch.arange(N * K, device=x.device)
    y = out[back].view(N, K, D)
    y = torch.where(held[:, :, None], y * w.to(y.dtype)[:, :, None], 0.0)
    y = y.sum(dim=1).view(B, S, D)
    if moe.num_shared_experts:
        y = y + L.ffn_apply(p["shared"], x)
    return y


__all__ = ["ExpertShare", "group_limited_topk", "held_range", "share_ffn"]
