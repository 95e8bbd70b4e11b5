"""Plain PyTorch shared-prefix (Hydragen-style) decode attention.

The counterpart of ``repro/kernels/shared_prefix_attention`` and the plain
version the CUDA kernel (``csrc/shared_prefix_attention.cu``) is held
against.  ``prefix_attention_ref`` is the kernel's function: one shared
prefix against every query row, an unnormalized partial.
``shared_prefix_attention_ref`` is the public op's function: that
partial, a decode-attention pass over each row's own suffix, and the
log-sum-exp merge of the JAX op (``ops.py:44-52`` there).

The op sees every prefix key from every query (the prefix lies in the
past of any real decode); only the suffix is masked by ``kp <= qp``.
The JAX package's oracle masks the prefix by ``kp <= qp`` too, so the two
agree only where ``q_positions >= P - 1``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.common import (NEG_INF, finalize_online_softmax,
                                        online_softmax_update, qk_logits)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def prefix_attention_ref(q, prefix_k, prefix_v, prefix_positions):
    """q: (B,H,Dh); prefix_k/v: (P,Hkv,Dh) shared by every row;
    prefix_positions: (P,) int32, a key is masked only where it is < 0.

    Returns the UNNORMALIZED partial ``(acc (B,H,Dh), m (B,H), l (B,H))``,
    all f32; a row with no valid key is pinned to ``(0, NEG_INF, 0)``.
    """
    B, H, Dh = q.shape
    Hkv = prefix_k.shape[1]
    G = H // Hkv
    # the B*G query rows of each KV head, as the kernel folds them
    qf = q.reshape(B, Hkv, G, Dh).transpose(0, 1).reshape(Hkv, B * G, Dh)
    mask = (prefix_positions >= 0)[None, :]
    dev = q.device
    accs, ms, ls = [], [], []
    for h in range(Hkv):
        logits = qk_logits(qf[h], prefix_k[:, h], 1.0 / math.sqrt(Dh))
        acc, m, l = online_softmax_update(
            logits, mask, prefix_v[:, h],
            torch.zeros((B * G, Dh), device=dev),
            torch.full((B * G,), NEG_INF, device=dev),
            torch.zeros((B * G,), device=dev))
        acc, m, l = finalize_online_softmax(acc, m, l, normalize=False)
        accs.append(acc)
        ms.append(m)
        ls.append(l)
    # (Hkv, B*G, ...) -> (B, H, ...)
    acc = torch.stack(accs).reshape(Hkv, B, G, Dh).transpose(0, 1)
    m = torch.stack(ms).reshape(Hkv, B, G).transpose(0, 1)
    l = torch.stack(ls).reshape(Hkv, B, G).transpose(0, 1)
    return (acc.reshape(B, H, Dh), m.reshape(B, H), l.reshape(B, H))


def merge_prefix_suffix(prefix, suffix, dtype):
    """The JAX op's log-sum-exp merge of the unnormalized prefix partial
    ``(acc_p, m_p, l_p)`` with the normalized suffix result ``(out_s,
    m_s, l_s)``; a row empty in both gives 0.  Returns (B,H,Dh) in
    ``dtype``."""
    acc_p, m_p, l_p = prefix
    out_s, m_s, l_s = suffix
    out_p = acc_p / torch.where(l_p == 0.0, 1.0, l_p)[..., None]
    m = torch.maximum(m_p, m_s)
    w_p = torch.exp(m_p - m) * l_p
    w_s = torch.exp(m_s - m) * l_s
    den = torch.where(w_p + w_s == 0.0, 1.0, w_p + w_s)
    out = (out_p.float() * w_p[..., None]
           + out_s.float() * w_s[..., None]) / den[..., None]
    return out.to(dtype)


def shared_prefix_attention_ref(q, prefix_k, prefix_v, suffix_k, suffix_v,
                                *, q_positions, suffix_positions):
    """q: (B,H,Dh); prefix_k/v: (P,Hkv,Dh), one copy for the batch, at
    positions 0..P-1 and visible to every query; suffix_k/v: (B,T,Hkv,Dh)
    with ``suffix_positions`` (B,T) int32 (-1 = empty slot), masked by
    ``kp <= q_positions``.  Returns (B,H,Dh) in q's dtype."""
    P = prefix_k.shape[0]
    prefix = prefix_attention_ref(
        q, prefix_k, prefix_v,
        torch.arange(P, dtype=torch.int32, device=q.device))
    suffix = decode_attention_ref(
        q, suffix_k, suffix_v, q_positions=q_positions,
        kv_positions=suffix_positions, window=0, return_lse=True)
    return merge_prefix_suffix(prefix, suffix, q.dtype)

