"""Grouped-query attention: the decoder of deepseek-llm-67b, qwen3 and
llama, and with a ``moe`` group DeepSeekMoE's layer under the port's
capacity clamp (deepseek-moe-16b).  The architecture of a configuration
that names none.

Layout (the port's ``load`` format, weights ``(in, out)``): ``embed``
(Vpad, d), ``final_norm`` (d,), ``lm_head`` (d, Vpad); per layer ``i``
``blocks.i.ln1``/``ln2`` (d,), ``blocks.i.attn.{wq,wk,wv,wo}``, then
either ``blocks.i.ffn.{w_gate,w_up,w_down}`` or
``blocks.i.moe.{router,w_gate,w_up,w_down}`` with the experts stacked on
a leading axis and ``blocks.i.moe.shared.{w_gate,w_up,w_down}``.  Norms
scale by ``1 + w``.  The router is float32, every other tensor is in the
configuration's dtype.  Vpad is the vocabulary rounded up to 256.

The reference (``served_logits``) runs pre-norm blocks, grouped-query
attention with rotary positions on split halves, a SwiGLU FFN or the MoE
layer (``reference/model.py`` states the clamp), a final norm and an
untied head.  The page pool holds float32 keys and values.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence, Tuple

import torch

from portbench.reference import model as R
from portbench.reference import weights as W


def _head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["num_heads"]


def layout(m: dict) -> Dict[str, Tuple[Tuple[int, ...], str, float]]:
    """``{key: (shape, dtype name, std)}`` of every tensor of the model
    described by a configuration file's ``model`` section."""
    d, h, hkv = m["d_model"], m["num_heads"], m["num_kv_heads"]
    dh = _head_dim(m)
    vpad = W.padded_vocab(m["vocab_size"])
    dt = m.get("dtype", "bfloat16")
    moe = m.get("moe")

    def mat(i, o):
        return ((i, o), dt, 1.0 / math.sqrt(i))

    out = {"embed": ((vpad, d), dt, W.EMBED_STD),
           "final_norm": ((d,), dt, W.NORM_STD),
           "lm_head": mat(d, vpad)}
    for i in range(m["num_layers"]):
        b = f"blocks.{i}."
        out[b + "ln1"] = ((d,), dt, W.NORM_STD)
        out[b + "ln2"] = ((d,), dt, W.NORM_STD)
        out[b + "attn.wq"] = mat(d, h * dh)
        out[b + "attn.wk"] = mat(d, hkv * dh)
        out[b + "attn.wv"] = mat(d, hkv * dh)
        out[b + "attn.wo"] = mat(h * dh, d)
        if moe is None or i < moe.get("first_dense_layers", 0):
            f = m["d_ff"] if moe is None else moe["d_ff_dense"]
            out[b + "ffn.w_gate"] = mat(d, f)
            out[b + "ffn.w_up"] = mat(d, f)
            out[b + "ffn.w_down"] = mat(f, d)
            continue
        e, fe = moe["num_experts"], moe["d_ff_expert"]
        out[b + "moe.router"] = ((d, e), "float32", 1.0 / math.sqrt(d))
        out[b + "moe.w_gate"] = ((e, d, fe), dt, 1.0 / math.sqrt(d))
        out[b + "moe.w_up"] = ((e, d, fe), dt, 1.0 / math.sqrt(d))
        out[b + "moe.w_down"] = ((e, fe, d), dt, 1.0 / math.sqrt(fe))
        fs = moe.get("num_shared_experts", 0) * fe
        if fs:
            out[b + "moe.shared.w_gate"] = mat(d, fs)
            out[b + "moe.shared.w_up"] = mat(d, fs)
            out[b + "moe.shared.w_down"] = mat(fs, d)
    return out


def kv_bytes_per_token(m: dict) -> int:
    """A float32 key and value of every KV head in every layer."""
    return 2 * m["num_layers"] * m["num_kv_heads"] * _head_dim(m) * 4


def matmul_params(m: dict) -> int:
    """Weights a token multiplies through (router, routed experts it
    picks, shared experts, attention and FFN projections, the head); the
    embedding is a lookup and is not counted."""
    d, h, hkv = m["d_model"], m["num_heads"], m["num_kv_heads"]
    dh = _head_dim(m)
    vpad = W.padded_vocab(m["vocab_size"])
    attn = d * h * dh + 2 * d * hkv * dh + h * dh * d
    moe = m.get("moe")
    total = d * vpad
    for i in range(m["num_layers"]):
        total += attn
        if moe is None:
            total += 3 * d * m["d_ff"]
        elif i < moe.get("first_dense_layers", 0):
            total += 3 * d * moe["d_ff_dense"]
        else:
            total += (moe["top_k"] + moe.get("num_shared_experts", 0)) \
                * 3 * d * moe["d_ff_expert"] + d * moe["num_experts"]
    return total


def token_flops(m: dict, contexts: Iterable[int]) -> float:
    """Model FLOPs of tokens that attend over ``contexts`` keys each: 2 x
    the weights a token multiplies through, plus 4 H Dh per key in every
    layer."""
    per_key = 4.0 * m["num_heads"] * _head_dim(m) * m["num_layers"]
    n, keys = 0, 0
    for c in contexts:
        n += 1
        keys += c
    return 2.0 * matmul_params(m) * n + per_key * keys


def _layer_weights(lay, seed, i, device, ops: R.Ops):
    pre = f"blocks.{i}."
    out = {}
    for key in lay:
        if not key.startswith(pre):
            continue
        rest = key[len(pre):]                # ln1, attn.wq, moe.shared.w_up
        name = rest.split(".", 1)[1] if "." in rest else rest
        t = W.draw(lay[key], seed, key, device)
        out[name] = t if t.dim() < 2 or name == "router" else ops.weight(t)
    return out


def served_logits(m: dict, seed: int,
                  seqs: Sequence[Tuple[Sequence[int], Sequence[int]]], *,
                  device, prefill_quantum: int = 16,
                  precision: str = "float32") -> List[torch.Tensor]:
    """Teacher-forced logits at every served position.

    ``seqs`` holds ``(prompt, served)`` token lists.  Each sequence runs
    over ``prompt + served[:-1]``; the result for it is ``(len(served),
    vocab_size)`` float32 on ``device``: row j is the logits that chose
    ``served[j]``.  Weights are drawn from ``layout`` at ``seed``."""
    lay = layout(m)
    ops = R.Ops(precision)
    h, hkv = m["num_heads"], m["num_kv_heads"]
    dh = _head_dim(m)
    eps = m.get("norm_eps", 1e-6)
    theta = m.get("rope_theta", 10000.0)
    moe = m.get("moe")
    with R.NoTF32():
        toks = [list(p) + list(s[:-1]) for p, s in seqs]
        embed = W.draw(lay["embed"], seed, "embed", device)
        xs = [embed[torch.as_tensor(t, device=device)].float()
              for t in toks]
        del embed
        for i in range(m["num_layers"]):
            p = _layer_weights(lay, seed, i, device, ops)
            for j, x in enumerate(xs):
                T = x.shape[0]
                a = R.rms_norm(x, p["ln1"], eps)
                q = R.rope(ops.mm(a, p["wq"]).reshape(T, h, dh), theta)
                k = R.rope(ops.mm(a, p["wk"]).reshape(T, hkv, dh), theta)
                v = ops.mm(a, p["wv"]).reshape(T, hkv, dh)
                x = x + ops.mm(R.attention(q, k, v), p["wo"])
                a = R.rms_norm(x, p["ln2"], eps)
                if "router" in p:
                    x = x + R.moe_layer(a, p, moe, len(seqs[j][0]),
                                        prefill_quantum, ops)
                else:
                    x = x + R.swiglu(a, p["w_gate"], p["w_up"],
                                     p["w_down"], ops)
                xs[j] = x
            del p
        final = W.draw(lay["final_norm"], seed, "final_norm", device)
        head = ops.weight(W.draw(lay["lm_head"], seed, "lm_head", device))
        out = []
        for (prompt, served), x in zip(seqs, xs):
            rows = x[len(prompt) - 1:len(prompt) - 1 + len(served)]
            out.append(ops.mm(R.rms_norm(rows, final, eps), head)
                       [:, :m["vocab_size"]])
    return out
