"""Plain PyTorch paged latent decode attention: gather each row's latent
pages dense, then one softmax over its valid keys.

The plain version the CUDA kernel (``csrc/latent_decode_attention.cu``)
is held against.  It has no counterpart in the JAX package, which has no
latent attention.
"""
from __future__ import annotations

import torch


def latent_decode_attention_ref(q, pool, page_table, lengths, *, scale: float,
                                v_dim: int):
    """q: (B, H, D) the absorbed queries; pool: (P, page, D) one layer's
    latents ``[c_kv; k_rope]``; page_table: (B, n_pages) int32; lengths:
    (B,) int32, the new token's position (-1 = padding).

    Key ``t`` of a row (page slot ``t // page``, ``t % page``) is valid
    while ``t <= lengths[b]``.  Returns ``softmax(q . key * scale)`` over
    the valid keys times their first ``v_dim`` values (``c_kv``), (B, H,
    v_dim) in q's dtype, computed in float32; a padding row gives 0."""
    B, n_pages = page_table.shape
    _, page_size, D = pool.shape
    T = n_pages * page_size
    keys = pool[page_table.long()].reshape(B, T, D).float()
    logits = torch.einsum("bhd,btd->bht", q.float(), keys) * scale
    t = torch.arange(T, device=q.device)
    valid = t[None, :] <= lengths[:, None].long()                 # (B, T)
    logits = logits.masked_fill(~valid[:, None, :], float("-inf"))
    live = lengths >= 0
    probs = torch.softmax(logits.masked_fill(~live[:, None, None], 0.0), -1)
    out = torch.einsum("bht,btd->bhd", probs, keys[..., :v_dim])
    return torch.where(live[:, None, None], out, 0.0).to(q.dtype)
