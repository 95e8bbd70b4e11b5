"""Plain PyTorch flash prefill attention (GQA, causal, window).

The counterpart of ``repro/kernels/flash_attention/ref.py`` and the
plain version the CUDA kernel is held against.  Masked logits are
NEG_INF and the softmax runs over all keys, so a row with no valid key
gives the uniform mean of V, as the Pallas kernel does.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.common import NEG_INF


def flash_attention_ref(q, k, v, *, q_positions, kv_positions, causal=True,
                        window=0):
    """q: (B,Sq,H,Dh); k,v: (B,Skv,Hkv,Dh); positions int32, -1 invalid.

    Logits and softmax in f32; probs are cast to V's dtype before PV, as
    the JAX reference does.  Returns (B,Sq,H,Dh) in V's dtype.
    """
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, Dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) / math.sqrt(Dh)
    qp = q_positions[:, None, None, :, None]
    kp = kv_positions[:, None, None, None, :]
    mask = kp >= 0
    if causal:
        mask = mask & (kp <= qp)
    if window:
        mask = mask & (kp > qp - window)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(),
                       v.float()).to(v.dtype)
    return out.reshape(B, Sq, H, Dh)
