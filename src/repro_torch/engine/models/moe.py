"""Mixture-of-Experts FFN (GShard-style grouped dispatch, capacity-clamped).

The counterpart of ``repro/engine/models/moe.py``.  The JAX function
reaches no Pallas kernel: it is einsums, scatters and gathers, and so is
this port, in plain PyTorch.  It keeps the reference's grouping and
capacity exactly, because they decide which tokens an expert drops:

* the ``N = B*S`` tokens form ``G = num_groups or min(B, 16)`` groups
  (decreased until ``N % G == 0``), each routed on its own;
* an expert takes at most ``capacity = max(ceil(Ng*K/E*cf), K)`` of a
  group's ``Ng*K`` routed slots, in row-major ``(token, k)`` order; the
  slots past it are dropped (they add exactly 0);
* the shared experts run on every token of the ungrouped ``x``.

So the tokens a prefill chunk drops depend on the chunk's length (its
padding included), as in the reference; a decode step's groups are one
token each while ``B <= 16``, so a step drops nothing and its routing
does not depend on the batch.

Layout: the dispatch buffer is ``(E, G, C, D)``, so each expert's three
products are one ``bmm`` over its ``G*C`` rows and its weights are read
once per call.  The scatter adds each kept slot's token into a buffer
position no other kept slot takes, and a dropped slot adds 0 to the last
one (as the reference does), so the accumulating ``index_put_`` gives the
same bits in any order.  The combine sums the K weighted expert outputs
in the activation dtype; in bf16 ``torch.sum`` accumulates them in f32
before it rounds, which the reference's XLA reduce need not do.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import MoEConfig
from repro_torch.engine.models import layers as L

def moe_init(gen: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype: torch.dtype) -> Dict:
    """Random expert weights from ``gen`` (on its device) with the JAX
    package's scales; the router stays float32 whatever ``dtype`` is."""
    E, Fe = cfg.num_experts, cfg.d_ff_expert

    def normal(*shape, fan_in):
        w = torch.randn(*shape, generator=gen, device=gen.device,
                        dtype=torch.float32)
        return w * (1.0 / math.sqrt(fan_in))

    p = {"router": normal(d_model, E, fan_in=d_model),
         "w_gate": normal(E, d_model, Fe, fan_in=d_model).to(dtype),
         "w_up": normal(E, d_model, Fe, fan_in=d_model).to(dtype),
         "w_down": normal(E, Fe, d_model, fan_in=Fe).to(dtype)}
    if cfg.num_shared_experts:
        p["shared"] = L.ffn_init(gen, d_model,
                                 cfg.num_shared_experts * Fe, dtype)
    return p


class MoE(nn.Module):
    """One layer's router, routed experts and shared experts; indexed by
    leaf name like the JAX param dict (``p["w_gate"]``)."""

    def __init__(self, d_model: int, cfg: MoEConfig, dtype, device):
        super().__init__()
        E, Fe = cfg.num_experts, cfg.d_ff_expert

        def param(*shape, dt=dtype):
            return nn.Parameter(torch.zeros(*shape, dtype=dt, device=device),
                                requires_grad=False)

        self.router = param(d_model, E, dt=torch.float32)
        self.w_gate = param(E, d_model, Fe)
        self.w_up = param(E, d_model, Fe)
        self.w_down = param(E, Fe, d_model)
        if cfg.num_shared_experts:
            Fs = cfg.num_shared_experts * Fe
            self.shared = nn.ParameterDict({
                n: param(*s) for n, s in (("w_gate", (d_model, Fs)),
                                          ("w_up", (d_model, Fs)),
                                          ("w_down", (Fs, d_model)))})

    def __getitem__(self, name: str):
        return getattr(self, name)


def _dispatch_indices(top_idx: torch.Tensor, num_experts: int,
                      capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """top_idx: (..., N, K) expert ids -> (slot positions within their
    expert, keep mask), each (..., N, K).

    The position of slot (n, k) inside its expert's buffer is the number
    of earlier slots of its group routed to the same expert, in row-major
    (n, k) order."""
    *lead, N, K = top_idx.shape
    flat = top_idx.reshape(*lead, N * K).long()
    onehot = F.one_hot(flat, num_experts)                   # (..., NK, E)
    pos = onehot.cumsum(-2) - 1
    pos_in_e = pos.gather(-1, flat[..., None])[..., 0]      # (..., NK)
    keep = pos_in_e < capacity
    return pos_in_e.reshape(*lead, N, K), keep.reshape(*lead, N, K)


def _group_moe(xg: torch.Tensor, p, cfg: MoEConfig, capacity: int):
    """xg: (G, Ng, D), the groups side by side -> (G, Ng, D) output and
    the Switch aux loss's load stats (frac_tokens, mean_probs), each
    (G, E)."""
    G, N, D = xg.shape
    E, K = cfg.num_experts, cfg.top_k
    dev = xg.device

    logits = xg.float() @ p["router"]                       # (G, N, E) f32
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, K, dim=-1)             # (G, N, K)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    pos, keep = _dispatch_indices(top_i, E, capacity)

    # ---- scatter the tokens into the (E, G, C, D) buffer -----------------
    e_idx = torch.where(keep, top_i.long(), E - 1).reshape(G, N * K)
    c_idx = torch.where(keep, pos, capacity - 1).reshape(G, N * K)
    g_idx = torch.arange(G, device=dev)[:, None].expand(G, N * K)
    src = xg.repeat_interleave(K, dim=1) \
        * keep.reshape(G, N * K, 1).to(xg.dtype)
    buf = xg.new_zeros(E, G, capacity, D)
    if L.sharded(buf):
        # DTensor may place the written buffer anew, which in place it
        # cannot
        buf = buf.index_put((e_idx, g_idx, c_idx), src, accumulate=True)
    else:
        buf.index_put_((e_idx, g_idx, c_idx), src, accumulate=True)

    # ---- the experts (SwiGLU), one bmm per product over G*C rows ----------
    rows = buf.view(E, G * capacity, D)
    h = F.silu(torch.bmm(rows, p["w_gate"])) * torch.bmm(rows, p["w_up"])
    out_buf = torch.bmm(h, p["w_down"]).view(E, G, capacity, D)

    # ---- combine ------------------------------------------------------------
    gathered = out_buf[e_idx, g_idx, c_idx]                 # (G, N*K, D)
    w = (top_w.reshape(G, N * K, 1)
         * keep.reshape(G, N * K, 1).to(top_w.dtype)).to(out_buf.dtype)
    out = (gathered * w).reshape(G, N, K, D).sum(dim=2)

    # ---- load-balancing stats (Switch aux loss terms) -----------------------
    frac_tokens = F.one_hot(top_i[..., 0].long(), E).float().mean(dim=1)
    return out, frac_tokens, probs.mean(dim=1)


def moe_ffn(x: torch.Tensor, p, cfg: MoEConfig, num_groups: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), the Switch aux loss, a float32
    scalar)."""
    B, S, D = x.shape
    N = B * S
    G = num_groups or min(B, 16)
    while N % G:
        G -= 1
    Ng = N // G
    capacity = max(int(math.ceil(Ng * cfg.top_k / cfg.num_experts
                                 * cfg.capacity_factor)), cfg.top_k)

    # under the hints the groups are made of rows placed for them, both
    # ways (DTensor views a regrouping of dims sharded otherwise wrongly)
    xg = L.constrain_rows(x, G).reshape(G, Ng, D)
    out, frac, meanp = _group_moe(xg, p, cfg, capacity)
    aux = cfg.num_experts * torch.mean(frac.mean(0) * meanp.mean(0))

    y = L.rows_grad(out.reshape(B, S, D), G)
    if cfg.num_shared_experts:
        y = y + L.ffn_apply(p["shared"], x)
    return y, aux.float()


__all__ = ["MoE", "moe_init", "moe_ffn"]
