"""Plain PyTorch GQA flash-decode over a contiguous or ring-buffer cache.

The counterpart of ``repro/kernels/decode_attention/ref.py`` and the
plain version the CUDA kernel (``csrc/decode_attention.cu``) is held
against.  The paged decode's plain version gathers its pages dense and
reuses ``decode_attention_ref``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.common import NEG_INF


def decode_attention_ref(q, k, v, *, q_positions, kv_positions, window=0,
                         return_lse=False):
    """q: (B,H,Dh) one new token; k,v: (B,T,Hkv,Dh); kv_positions (B,T)
    with -1 for an empty slot.

    A key is valid when ``0 <= kp <= qp`` and, with ``window``, ``kp >
    qp - window``.  Logits and softmax in f32; a row with no valid key
    gives out 0 and ``(m, l) = (NEG_INF, 0)``.  Returns out (B,H,Dh) in
    q's dtype; with ``return_lse`` also (m, l), each (B,H) f32, the
    running max and sum of a log-sum-exp combine.
    """
    B, H, Dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, Dh)
    logits = torch.einsum("bhgd,bkhd->bhgk", qg.float(),
                          k.float()) / math.sqrt(Dh)
    qp = q_positions.reshape(B)[:, None, None, None]
    kp = kv_positions[:, None, None, :]
    mask = (kp >= 0) & (kp <= qp)
    if window:
        mask = mask & (kp > qp - window)
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1)                                  # (B,Hkv,G)
    p = torch.exp(logits - m[..., None])
    p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    out = out / torch.where(l == 0.0, 1.0, l)[..., None]
    out = out.reshape(B, H, Dh).to(q.dtype)
    if return_lse:
        return out, m.reshape(B, H), l.reshape(B, H)
    return out


def lse_combine(parts):
    """Combine partial results ``[(out_i (B,H,Dh), m_i (B,H), l_i (B,H))]``
    over disjoint key sets into the result over their union.  Empty parts
    (``l == 0``) weigh nothing; a row empty in every part gives 0."""
    m = torch.stack([p[1] for p in parts]).amax(dim=0)      # (B,H)
    num = 0.0
    den = 0.0
    for out_i, m_i, l_i in parts:
        w = torch.exp(m_i - m) * l_i                         # (B,H)
        num = num + out_i.float() * w[..., None]
        den = den + w
    den = torch.where(den == 0.0, 1.0, den)
    return (num / den[..., None]).to(parts[0][0].dtype)
