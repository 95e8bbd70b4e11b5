"""The plain float32 reference's parts, and its entry point.

The reference of an architecture is its module's ``served_logits``
(``archs/<arch>.py``).  That of ``archs/gqa.py``, which
``served_logits`` here runs, assembles these parts: pre-norm blocks
with RMS norm scaled by ``1 + w``, grouped-query attention with rotary
positions on split halves, a SwiGLU FFN or DeepSeekMoE's layer (a
float32 softmax router, the top-k weights renormalized, routed experts
under the port's capacity clamp, shared experts on every token), a final
norm and an untied head.  No kernels, no cache, no batching: each
sequence runs whole, teacher-forced, one layer at a time over all the
sequences, so that one layer's weights are live at a time.

The capacity clamp is the port's departure from DeepSeekMoE (which
routes without one), stated in the configuration file: a prompt is one
routing group of its length rounded up to ``prefill_quantum`` (the
padding rows route after every real row, so they take no real row's
place); an expert keeps at most ``max(ceil(n_pad * top_k / E * cf),
top_k)`` of the group's slots, in row-major (token, k) order.  A decode
token is a group of its own and is never clamped.

``precision="fp8"`` is the control: every product with a bf16 weight
takes its inputs rounded to float8 e4m3 (weights per output column,
activations per row, each scaled to the format's range), as a port that
moved its GEMMs one precision down would.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.archs import default

_FP8_MAX = 448.0
_Q_BLOCK = 256


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3, scaled along ``dim``'s absolute max."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / _FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Ops:
    def __init__(self, precision: str):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A bf16 weight ``(..., in, out)`` as the products take it."""
        w = w.float()
        return _fp8(w, dim=-2) if self.fp8 else w

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return (_fp8(x, dim=-1) if self.fp8 else x) @ w


class NoTF32:
    """A context in which float32 products run in full float32: TF32 off
    for cuBLAS and cuDNN, restored as it was on the way out."""

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


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, H, Dh) at positions 0..T-1, split halves rotated."""
    T, _, dh = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                         device=x.device) / dh)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v):
    """Causal GQA: q (T, H, Dh) over k, v (T, Hkv, Dh), in query blocks."""
    T, H, dh = q.shape
    hkv = k.shape[1]
    g = H // hkv
    qg = q.reshape(T, hkv, g, dh).permute(1, 2, 0, 3)        # (Hkv,G,T,Dh)
    kt = k.permute(1, 0, 2)                                  # (Hkv,T,Dh)
    vt = v.permute(1, 0, 2)
    out = torch.empty_like(qg)
    for s in range(0, T, _Q_BLOCK):
        e = min(T, s + _Q_BLOCK)
        logits = torch.einsum("hgqd,hkd->hgqk", qg[:, :, s:e], kt[:, :e]) \
            / math.sqrt(dh)
        mask = torch.arange(e, device=q.device)[None, :] \
            > torch.arange(s, e, device=q.device)[:, None]
        logits = logits.masked_fill(mask, float("-inf"))
        out[:, :, s:e] = torch.einsum("hgqk,hkd->hgqd",
                                      torch.softmax(logits, -1), vt[:, :e])
    return out.permute(2, 0, 1, 3).reshape(T, H * dh)


def swiglu(x, wg, wu, wd, ops: Ops):
    return ops.mm(F.silu(ops.mm(x, wg)) * ops.mm(x, wu), wd)


def capacity(n_rows: int, moe: dict, quantum: int) -> int:
    n_pad = -(-n_rows // quantum) * quantum
    return max(int(math.ceil(n_pad * moe["top_k"] / moe["num_experts"]
                             * moe.get("capacity_factor", 1.25))),
               moe["top_k"])


def moe_layer(h, p, moe: dict, prompt_len: int, quantum: int, ops: Ops):
    """h (T, d): rows ``< prompt_len`` are the prompt's routing group."""
    E, K = moe["num_experts"], moe["top_k"]
    probs = torch.softmax(h @ p["router"].float(), dim=-1)
    top_w, top_i = torch.topk(probs, K, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    keep = torch.ones_like(top_i, dtype=torch.bool)
    n = min(prompt_len, h.shape[0])
    flat = top_i[:n].reshape(-1)
    pos = F.one_hot(flat, E).cumsum(0).gather(1, flat[:, None])[:, 0] - 1
    keep[:n] = (pos < capacity(prompt_len, moe, quantum)).reshape(n, K)
    y = torch.zeros_like(h)
    for e in range(E):
        tok, slot = torch.nonzero((top_i == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        out = swiglu(h[tok], p["w_gate"][e], p["w_up"][e], p["w_down"][e],
                     ops)
        y.index_add_(0, tok, out * top_w[tok, slot][:, None])
    if "shared.w_gate" in p:
        y = y + swiglu(h, p["shared.w_gate"], p["shared.w_up"],
                       p["shared.w_down"], ops)
    return y


def served_logits(m: dict, seed: int,
                  seqs: Sequence[Tuple[Sequence[int], Sequence[int]]], *,
                  device, prefill_quantum: int = 16,
                  precision: str = "float32") -> List[torch.Tensor]:
    """Teacher-forced logits at every served position, by the ``gqa``
    reference (``archs/gqa.py``).

    ``seqs`` holds ``(prompt, served)`` token lists.  Each sequence runs
    over ``prompt + served[:-1]``; the result for it is ``(len(served),
    vocab_size)`` float32 on ``device``: row j is the logits that chose
    ``served[j]``.  Weights come from ``weights.make`` at ``seed``."""
    return default(m).served_logits(
        m, seed, seqs, device=device, prefill_quantum=prefill_quantum,
        precision=precision)
