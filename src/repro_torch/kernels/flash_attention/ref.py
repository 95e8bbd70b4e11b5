"""Plain PyTorch flash prefill attention (GQA, causal, window), and its
backward.

``flash_attention_ref`` is the counterpart of
``repro/kernels/flash_attention/ref.py`` and the plain version the CUDA
kernel is held against.  Masked logits are NEG_INF and the softmax runs
over all keys, so a row with no valid key gives the uniform mean of V, as
the Pallas kernel does.

``flash_attention_bwd_ref`` is the gradient of that function written out,
the plain version of ``csrc/flash_attention_bwd.cu`` (the JAX package has
none: it differentiates ``attention_xla`` with XLA).  The ``where`` gives
masked logits no gradient, so a row with no valid key gets dQ = 0 and adds
nothing to dK, while its uniform P sends dO/Skv to every key's dV.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.common import NEG_INF


def _logits(q, k, q_positions, kv_positions, causal, window):
    """(mask, logits) of shape (B,Hkv,G,Sq,Skv): scaled logits in f32,
    NEG_INF where masked."""
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, Dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) / math.sqrt(Dh)
    qp = q_positions[:, None, None, :, None]
    kp = kv_positions[:, None, None, None, :]
    mask = kp >= 0
    if causal:
        mask = mask & (kp <= qp)
    if window:
        mask = mask & (kp > qp - window)
    return mask, torch.where(mask, logits, NEG_INF)


def _probs(q, k, q_positions, kv_positions, causal, window):
    """(mask, probs): the softmax of ``_logits`` over every key."""
    mask, logits = _logits(q, k, q_positions, kv_positions, causal, window)
    return mask, torch.softmax(logits, dim=-1)


def flash_attention_lse_ref(q, k, *, q_positions, kv_positions, causal=True,
                            window=0):
    """(B,H,Sq) f32: each row's log-sum-exp of its scaled logits over its
    valid keys, NEG_INF for a row with none (the mark the forward kernel
    writes, which the backward reads as a uniform row)."""
    B, Sq, H, _ = q.shape
    mask, logits = _logits(q, k, q_positions, kv_positions, causal, window)
    lse = torch.logsumexp(logits, dim=-1)
    lse = torch.where(mask.any(dim=-1), lse, NEG_INF)      # (B,Hkv,G,Sq)
    return lse.reshape(B, H, Sq)


def flash_attention_ref(q, k, v, *, q_positions, kv_positions, causal=True,
                        window=0):
    """q: (B,Sq,H,Dh); k,v: (B,Skv,Hkv,Dh); positions int32, -1 invalid.

    Logits and softmax in f32; probs are cast to V's dtype before PV, as
    the JAX reference does.  Returns (B,Sq,H,Dh) in V's dtype.
    """
    _, probs = _probs(q, k, q_positions, kv_positions, causal, window)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(),
                       v.float()).to(v.dtype)
    return out.reshape(q.shape)


def flash_attention_bwd_ref(q, k, v, dout, *, q_positions, kv_positions,
                            causal=True, window=0):
    """The gradient of ``flash_attention_ref`` at (q, k, v) for the output
    gradient ``dout`` (B,Sq,H,Dh).  Returns (dq, dk, dv) in the dtypes of
    q, k and v.

    P is recomputed from the logits; dV = P_v^T dO with P cast to V's dtype
    as the forward casts it; dS = P o (dP - rowsum(P o dP)) with dP = dO
    V^T, zero where masked; dQ = dS K / sqrt(Dh) and dK = dS^T Q / sqrt(Dh),
    summed over the G query heads of each KV head.  All in f32.
    """
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    mask, probs = _probs(q, k, q_positions, kv_positions, causal, window)
    qg = q.reshape(B, Sq, Hkv, H // Hkv, Dh).float()
    dog = dout.reshape(qg.shape).float()
    dv = torch.einsum("bhgqk,bqhgd->bkhd", probs.to(v.dtype).float(), dog)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = probs * (dp - (probs * dp).sum(dim=-1, keepdim=True))
    ds = torch.where(mask, ds, 0.0)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) / math.sqrt(Dh)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) / math.sqrt(Dh)
    return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
