"""The plain float32 reference of DeepSeek-V2 as the port serves it.

Follows the published equations (arXiv:2405.04434 and the published
``config.json``): latent attention in the non-absorbed form (every head's
key ``[c_kv W_UK; k_rope]`` and value ``c_kv W_UV``, causal softmax at
``s = mscale_yarn^2 / sqrt(qk_nope + qk_rope)``), YaRN rotary positions,
the dense lead layers, and ``group_limited_greedy`` routing over all the
router's experts with only the held experts computed.  Plain ``torch`` in
float32, TF32 off (``no_tf32``); no kernel of the port, no cache, no
batching: one sequence at a time, teacher-forced.  It imports nothing of
the port, so it holds the port to the equations rather than to itself.

Departures, the port's as well: norms scale by ``1 + w``; the rotary
dimensions pair as split halves (the published checkpoint interleaves
them: a permutation of the rope weights' columns); each expert layer
holds the experts ``held_start .. held_start + held_count - 1`` and
gives their part of the result plus the shared experts (the other
cards' experts are left out, as on one card of the deployment).

Weights are the port's state dict (``MLATransformerLM.state_dict()``):
``(in, out)`` matrices, the held experts stacked on a leading axis.
``portbench/archs/mla.py`` keeps a copy of this file's arithmetic for
the benchmark, which draws the weights layer by layer.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F


class no_tf32:
    """A context in which float32 products run in full float32."""

    def __enter__(self):
        self._prev = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._prev
        return False


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + w.float())


def _mscale(factor, m):
    return 0.1 * m * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn(mla, theta, T, device):
    """(cos, sin) of positions 0..T-1, each (T, dr / 2), and the score
    scale s."""
    dim = mla.qk_rope_head_dim
    base = theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                  device=device) / dim)

    def corr(rot):
        return dim * math.log(mla.original_max_position
                              / (rot * 2 * math.pi)) / (2 * math.log(theta))

    lo = max(math.floor(corr(mla.beta_fast)), 0)
    hi = min(math.ceil(corr(mla.beta_slow)), dim - 1)
    if lo == hi:
        hi += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - lo)
            / (hi - lo)).clamp(0, 1)
    extra = 1.0 - ramp                      # weight of the original freqs
    inv = (1.0 / (mla.rope_factor * base)) * ramp + (1.0 / base) * extra
    ang = torch.arange(T, dtype=torch.float32, device=device)[:, None] * inv
    c = _mscale(mla.rope_factor, mla.mscale) \
        / _mscale(mla.rope_factor, mla.mscale_all_dim)
    s = (mla.qk_nope_head_dim + mla.qk_rope_head_dim) ** -0.5
    if mla.rope_factor > 1:
        s *= _mscale(mla.rope_factor, mla.mscale_all_dim) ** 2
    return torch.cos(ang) * c, torch.sin(ang) * c, s


def rope(x, cos, sin):
    """x (T, H, dr): split halves rotated."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[:, None], sin[:, None]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(x, p, mla, H, eps, cos, sin, s):
    """Latent attention of one sequence x (T, D), non-absorbed."""
    T = x.shape[0]
    dn, dr, dv = mla.qk_nope_head_dim, mla.qk_rope_head_dim, mla.v_head_dim
    r = mla.kv_lora_rank
    q = (rms_norm(x @ p["wq_a"], p["q_norm"], eps) @ p["wq_b"]) \
        .view(T, H, dn + dr)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], cos, sin)], dim=-1)
    kv = x @ p["wkv_a"]
    c_kv = rms_norm(kv[:, :r], p["kv_norm"], eps)
    k_rope = rope(kv[:, None, r:], cos, sin)                  # (T, 1, dr)
    kvb = (c_kv @ p["wkv_b"]).view(T, H, dn + dv)
    k = torch.cat([kvb[..., :dn], k_rope.expand(T, H, dr)], dim=-1)
    v = kvb[..., dn:]
    logits = torch.einsum("qhd,khd->hqk", q, k) * s
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).triu(1)
    probs = torch.softmax(logits.masked_fill(mask, float("-inf")), dim=-1)
    return torch.einsum("hqk,khd->qhd", probs, v).reshape(T, H * dv) \
        @ p["wo"]


def swiglu(x, wg, wu, wd):
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def route(x, router, moe, routing):
    """group_limited_greedy: (weights (T, K), experts (T, K))."""
    T = x.shape[0]
    E, G = moe.num_experts, routing.n_group
    probs = torch.softmax(x @ router.float(), dim=-1)
    groups = probs.view(T, G, E // G)
    kept = torch.topk(groups.amax(-1), routing.topk_group, dim=-1).indices
    mask = torch.zeros(T, G, dtype=torch.bool, device=x.device)
    mask[torch.arange(T, device=x.device)[:, None], kept] = True
    w, idx = torch.topk(groups.masked_fill(~mask[..., None], 0.0)
                        .view(T, E), moe.top_k, dim=-1)
    if routing.norm_topk_prob:
        w = w / w.sum(-1, keepdim=True)
    return w * routing.routed_scaling_factor, idx


def expert_layer(x, p, moe, routing, held_start, held_count):
    """The held experts' part of the layer plus the shared experts, over
    x (T, D); ``p["w_gate"][j]`` is expert ``held_start + j``."""
    w, idx = route(x, p["router"], moe, routing)
    y = torch.zeros_like(x)
    for j in range(held_count):
        tok, slot = torch.nonzero(idx == held_start + j, as_tuple=True)
        if tok.numel():
            y.index_add_(0, tok, swiglu(x[tok], p["w_gate"][j], p["w_up"][j],
                                        p["w_down"][j])
                         * w[tok, slot][:, None])
    if "shared.w_gate" in p:
        y = y + swiglu(x, p["shared.w_gate"], p["shared.w_up"],
                       p["shared.w_down"])
    return y


def logits(cfg, params: Dict[str, torch.Tensor],
           tokens: Sequence[int]) -> torch.Tensor:
    """(T, vocab_size) float32 logits of one sequence, teacher-forced;
    ``cfg`` is the port's ``ModelConfig`` (``mla``, ``moe``, ``routing``
    set)."""
    mla, moe, routing = cfg.mla, cfg.moe, cfg.routing
    held = routing.held_count or moe.num_experts
    eps = cfg.norm_eps
    P = {k: v.float() for k, v in params.items()}
    with no_tf32():
        dev = P["embed"].device
        x = P["embed"][torch.as_tensor(list(tokens), device=dev)]
        cos, sin, s = yarn(mla, cfg.rope_theta, x.shape[0], dev)
        for i in range(cfg.num_layers):
            pre = f"blocks.{i}."
            lay = {k[len(pre):]: v for k, v in P.items()
                   if k.startswith(pre)}
            attn = {k[5:]: v for k, v in lay.items()
                    if k.startswith("attn.")}
            x = x + attention(rms_norm(x, lay["ln1"], eps), attn, mla,
                              cfg.num_heads, eps, cos, sin, s)
            h = rms_norm(x, lay["ln2"], eps)
            if "moe.router" in lay:
                ex = {k[4:]: v for k, v in lay.items() if k.startswith("moe.")}
                x = x + expert_layer(h, ex, moe, routing,
                                     routing.held_start, held)
            else:
                x = x + swiglu(h, lay["ffn.w_gate"], lay["ffn.w_up"],
                               lay["ffn.w_down"])
        head = P["embed"].T if cfg.tie_embeddings else P["lm_head"]
        return (rms_norm(x, P["final_norm"], eps) @ head)[:, :cfg.vocab_size]
