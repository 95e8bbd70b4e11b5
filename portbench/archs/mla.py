"""Multi-head latent attention with DeepSeek-V2's expert share: the
decoder of DeepSeek-V2 (arXiv:2405.04434), served by the port's
``MLATransformerLM`` over a latent page pool.

The ``model`` section names ``"arch": "mla"`` and carries the port's
``ModelConfig`` fields: ``num_heads`` (and ``num_kv_heads`` equal to it),
``head_dim`` (qk_nope + qk_rope), ``d_ff`` (the dense lead layers'
width), and the groups ``mla`` (``MLAConfig``), ``moe`` (``MoEConfig``:
``num_experts`` is the router's, every expert) and ``routing``
(``RoutingConfig``: the group-limited gate and the experts held,
``held_start`` .. ``held_start + held_count - 1``).  The harness passes
the section through (``cell.model_config``; the port's ``ModelConfig``
takes ``mla`` and ``routing`` as dicts), so this module gives no
``port_config``: it may import nothing of the port.

Layout (the port's ``load`` format, weights ``(in, out)``): ``embed``
(Vpad, d), ``final_norm`` (d,), ``lm_head`` (d, Vpad); per layer ``i``
``blocks.i.ln1``/``ln2`` (d,), ``blocks.i.attn.wq_a`` (d, q_lora),
``attn.q_norm`` (q_lora,), ``attn.wq_b`` (q_lora, H (dn + dr)),
``attn.wkv_a`` (d, kv_lora + dr), ``attn.kv_norm`` (kv_lora,),
``attn.wkv_b`` (kv_lora, H (dn + dv)), ``attn.wo`` (H dv, d); then the
lead layers' ``ffn.{w_gate,w_up,w_down}``, or ``moe.router`` (d, E) in
float32, the held experts ``moe.{w_gate,w_up}`` (held, d, Fe) and
``moe.w_down`` (held, Fe, d), and ``moe.shared.*``.  Norms scale by
``1 + w``.

The reference (``served_logits``) is a copy of the port's plain float32
reference, ``src/repro_torch/engine/models/deepseek_v2_ref.py``, with its
weights drawn here layer by layer: non-absorbed latent attention, YaRN,
group-limited routing over all E experts with only the held ones
computed, the shared experts, TF32 off.  Its departures are that file's:
norms by ``1 + w``, the rotary dimensions paired as split halves, the
held share.  With ``precision="fp8"`` every product with a bf16 weight
takes float8 inputs (``reference.model.Ops``).  The page pool holds one
float32 latent ``[c_kv; k_rope]`` a token a layer.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence, Tuple

import torch

from portbench.reference import model as R
from portbench.reference import weights as W
from portbench.yardstick import costs as Y


def _held(m: dict) -> Tuple[int, int]:
    r = m["routing"]
    return r.get("held_start", 0), r.get("held_count") or \
        m["moe"]["num_experts"]


def layout(m: dict) -> Dict[str, Tuple[Tuple[int, ...], str, float]]:
    """``{key: (shape, dtype name, std)}`` of every tensor of the model
    described by a configuration file's ``model`` section."""
    d, h = m["d_model"], m["num_heads"]
    a, moe = m["mla"], m["moe"]
    dn, dr, dv = a["qk_nope_head_dim"], a["qk_rope_head_dim"], \
        a["v_head_dim"]
    ql, kl = a["q_lora_rank"], a["kv_lora_rank"]
    vpad = W.padded_vocab(m["vocab_size"])
    dt = m.get("dtype", "bfloat16")
    _, held = _held(m)

    def mat(i, o):
        return ((i, o), dt, 1.0 / math.sqrt(i))

    def norm(n):
        return ((n,), dt, W.NORM_STD)

    out = {"embed": ((vpad, d), dt, W.EMBED_STD), "final_norm": norm(d),
           "lm_head": mat(d, vpad)}
    for i in range(m["num_layers"]):
        b = f"blocks.{i}."
        out[b + "ln1"] = norm(d)
        out[b + "ln2"] = norm(d)
        out[b + "attn.wq_a"] = mat(d, ql)
        out[b + "attn.q_norm"] = norm(ql)
        out[b + "attn.wq_b"] = mat(ql, h * (dn + dr))
        out[b + "attn.wkv_a"] = mat(d, kl + dr)
        out[b + "attn.kv_norm"] = norm(kl)
        out[b + "attn.wkv_b"] = mat(kl, h * (dn + dv))
        out[b + "attn.wo"] = mat(h * dv, d)
        if i < moe.get("first_dense_layers", 0):
            f = moe["d_ff_dense"]
            out[b + "ffn.w_gate"] = mat(d, f)
            out[b + "ffn.w_up"] = mat(d, f)
            out[b + "ffn.w_down"] = mat(f, d)
            continue
        fe = moe["d_ff_expert"]
        out[b + "moe.router"] = ((d, moe["num_experts"]), "float32",
                                 1.0 / math.sqrt(d))
        out[b + "moe.w_gate"] = ((held, d, fe), dt, 1.0 / math.sqrt(d))
        out[b + "moe.w_up"] = ((held, d, fe), dt, 1.0 / math.sqrt(d))
        out[b + "moe.w_down"] = ((held, fe, d), dt, 1.0 / math.sqrt(fe))
        fs = moe.get("num_shared_experts", 0) * fe
        if fs:
            out[b + "moe.shared.w_gate"] = mat(d, fs)
            out[b + "moe.shared.w_up"] = mat(d, fs)
            out[b + "moe.shared.w_down"] = mat(fs, d)
    return out


def kv_bytes_per_token(m: dict) -> int:
    """One float32 latent, ``kv_lora_rank + qk_rope_head_dim`` wide, in
    every layer."""
    a = m["mla"]
    return m["num_layers"] * (a["kv_lora_rank"] + a["qk_rope_head_dim"]) * 4


def matmul_params(m: dict) -> float:
    """Weights a token multiplies through: the latent attention's five
    projections, the dense lead layers' FFN, and in an expert layer the
    router, the shared experts and the routed experts at the share's
    expected slots a token, ``top_k x held / num_experts`` (6 x 20 / 160
    = 0.75 at deepseek-v2-l30e20; routing that favours the held group
    moves the true count); the head.  The embedding is a lookup."""
    d, h = m["d_model"], m["num_heads"]
    a, moe = m["mla"], m["moe"]
    dn, dr, dv = a["qk_nope_head_dim"], a["qk_rope_head_dim"], \
        a["v_head_dim"]
    ql, kl = a["q_lora_rank"], a["kv_lora_rank"]
    _, held = _held(m)
    attn = d * ql + ql * h * (dn + dr) + d * (kl + dr) + kl * h * (dn + dv) \
        + h * dv * d
    fe = moe["d_ff_expert"]
    routed = moe["top_k"] * held / moe["num_experts"]
    total = d * W.padded_vocab(m["vocab_size"])
    for i in range(m["num_layers"]):
        total += attn
        if i < moe.get("first_dense_layers", 0):
            total += 3 * d * moe["d_ff_dense"]
        else:
            total += d * moe["num_experts"] + (
                routed + moe.get("num_shared_experts", 0)) * 3 * d * fe
    return total


def token_flops(m: dict, contexts: Iterable[int]) -> float:
    """Model FLOPs of tokens that attend over ``contexts`` keys each: 2 x
    the weights a token multiplies through, plus 2 H (dn + dr + dv) a key
    in every layer (the scores at the query-key width, the values at
    theirs)."""
    a = m["mla"]
    per_key = 2.0 * m["num_heads"] * (a["qk_nope_head_dim"]
                                      + a["qk_rope_head_dim"]
                                      + a["v_head_dim"]) * m["num_layers"]
    n, keys = 0, 0
    for c in contexts:
        n += 1
        keys += c
    return 2.0 * matmul_params(m) * n + per_key * keys


def latent_decode_cost(m: dict, page_size: int, lengths: Sequence[int]
                       ) -> Tuple[float, float]:
    """(HBM bytes, FLOPs) of one launch of the latent decode kernel (one
    layer of one step) over rows whose new token sits at ``lengths``
    (-1: a padding row, which costs nothing): each valid key's float32
    latent read once (the new token's included), the bf16 absorbed query
    read and the bf16 latent output written once; 2 H (D + dv_latent)
    operations a valid key (scores over the latent's D, values over
    ``kv_lora_rank``).  The token's latent is scattered into its page by
    a launch of its own, before the kernel, and is not counted here.
    The products run on the tensor cores in bf16: the bound takes the
    bf16 peak.  ``page_size`` does not enter: the kernel reads keys, not
    whole pages."""
    a = m["mla"]
    D = a["kv_lora_rank"] + a["qk_rope_head_dim"]
    dv = a["kv_lora_rank"]
    h = m["num_heads"]
    live = [ln for ln in lengths if ln >= 0]
    keys = sum(ln + 1 for ln in live)
    nbytes = keys * D * 4 + len(live) * h * (D + dv) * 2
    return float(nbytes), 2.0 * h * (D + dv) * keys


def flash_width(m: dict) -> int:
    """The head width the port's flash kernel runs a prefill at: every
    head zero-padded to the next power of two of the query-key and the
    value widths' larger (256 at DeepSeek-V2's 192 and 128)."""
    a = m["mla"]
    w = max(a["qk_nope_head_dim"] + a["qk_rope_head_dim"], a["v_head_dim"])
    return 1 << (w - 1).bit_length()


def prefill_flash_cost(m: dict, pos0: int, n: int) -> Tuple[float, float]:
    """(HBM bytes, FLOPs) of the flash kernel's work for one row of a
    prefill call in one layer, as the kernel runs it: ``n`` real queries
    after ``pos0`` cached positions, every one of the H heads (H query
    and H key-value heads) at ``flash_width`` in bf16; q read and o
    written once, the ``pos0 + n`` keys and values read once, 4 H
    ``flash_width`` operations a causal pair (``yardstick.costs``).  Of
    those operations the model's own are 2 H (dn + dr + dv) a pair, 62.5%
    at DeepSeek-V2 (2 x 320 of 4 x 256): the padding is 1.33 times the
    score work and 2 times the value work.  A batched call's padded
    queries are left out, as ``flash_roofline`` leaves them out."""
    h = m["num_heads"]
    return Y.flash_prefill_cost(h, h, flash_width(m), pos0, n)


# --- the reference: a copy of deepseek_v2_ref.py's arithmetic ------------

def _mscale(factor, mscale):
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def _yarn(a: dict, theta: float, T: int, device):
    """(cos, sin) of positions 0..T-1, each (T, dr / 2), and the score
    scale s."""
    dim = a["qk_rope_head_dim"]
    factor = a.get("rope_factor", 1.0)
    base = theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                  device=device) / dim)

    def corr(rot):
        return dim * math.log(a["original_max_position"]
                              / (rot * 2 * math.pi)) / (2 * math.log(theta))

    lo = max(math.floor(corr(a["beta_fast"])), 0)
    hi = min(math.ceil(corr(a["beta_slow"])), dim - 1)
    if lo == hi:
        hi += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - lo)
            / (hi - lo)).clamp(0, 1)
    extra = 1.0 - ramp
    inv = (1.0 / (factor * base)) * ramp + (1.0 / base) * extra
    ang = torch.arange(T, dtype=torch.float32, device=device)[:, None] * inv
    c = _mscale(factor, a["mscale"]) / _mscale(factor, a["mscale_all_dim"])
    s = (a["qk_nope_head_dim"] + dim) ** -0.5
    if factor > 1:
        s *= _mscale(factor, a["mscale_all_dim"]) ** 2
    return torch.cos(ang) * c, torch.sin(ang) * c, s


def _rope(x, cos, sin):
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[:, None], sin[:, None]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _attention(x, p, a, H, eps, cos, sin, s, ops: R.Ops):
    T = x.shape[0]
    dn, dr, dv = a["qk_nope_head_dim"], a["qk_rope_head_dim"], \
        a["v_head_dim"]
    r = a["kv_lora_rank"]
    q = ops.mm(R.rms_norm(ops.mm(x, p["wq_a"]), p["q_norm"], eps),
               p["wq_b"]).view(T, H, dn + dr)
    q = torch.cat([q[..., :dn], _rope(q[..., dn:], cos, sin)], dim=-1)
    kv = ops.mm(x, p["wkv_a"])
    c_kv = R.rms_norm(kv[:, :r], p["kv_norm"], eps)
    k_rope = _rope(kv[:, None, r:], cos, sin)
    kvb = ops.mm(c_kv, p["wkv_b"]).view(T, H, dn + dv)
    k = torch.cat([kvb[..., :dn], k_rope.expand(T, H, dr)], dim=-1)
    v = kvb[..., dn:]
    logits = torch.einsum("qhd,khd->hqk", q, k) * s
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).triu(1)
    probs = torch.softmax(logits.masked_fill(mask, float("-inf")), dim=-1)
    return ops.mm(torch.einsum("hqk,khd->qhd", probs, v).reshape(T, H * dv),
                  p["wo"])


def _route(x, router, moe: dict, routing: dict):
    T = x.shape[0]
    E, G = moe["num_experts"], routing["n_group"]
    probs = torch.softmax(x @ router.float(), dim=-1)
    groups = probs.view(T, G, E // G)
    kept = torch.topk(groups.amax(-1), routing["topk_group"], dim=-1).indices
    mask = torch.zeros(T, G, dtype=torch.bool, device=x.device)
    mask[torch.arange(T, device=x.device)[:, None], kept] = True
    w, idx = torch.topk(groups.masked_fill(~mask[..., None], 0.0)
                        .view(T, E), moe["top_k"], dim=-1)
    if routing.get("norm_topk_prob", False):
        w = w / w.sum(-1, keepdim=True)
    return w * routing["routed_scaling_factor"], idx


def _expert_layer(x, p, m: dict, ops: R.Ops):
    moe, routing = m["moe"], m["routing"]
    start, held = _held(m)
    w, idx = _route(x, p["router"], moe, routing)
    y = torch.zeros_like(x)
    for j in range(held):
        tok, slot = torch.nonzero(idx == start + j, as_tuple=True)
        if tok.numel():
            y.index_add_(0, tok, R.swiglu(x[tok], p["w_gate"][j],
                                          p["w_up"][j], p["w_down"][j], ops)
                         * w[tok, slot][:, None])
    if "shared.w_gate" in p:
        y = y + R.swiglu(x, p["shared.w_gate"], p["shared.w_up"],
                         p["shared.w_down"], ops)
    return y


def _layer_weights(lay, seed, i, device, ops: R.Ops):
    pre = f"blocks.{i}."
    out = {}
    for key in lay:
        if not key.startswith(pre):
            continue
        rest = key[len(pre):]                # ln1, attn.wq_a, moe.shared.w_up
        name = rest.split(".", 1)[1] if "." in rest else rest
        t = W.draw(lay[key], seed, key, device)
        out[name] = t.float() if t.dim() < 2 or name == "router" \
            else ops.weight(t)
    return out


def served_logits(m: dict, seed: int,
                  seqs: Sequence[Tuple[Sequence[int], Sequence[int]]], *,
                  device, prefill_quantum: int = 16,
                  precision: str = "float32") -> List[torch.Tensor]:
    """Teacher-forced logits at every served position: ``seqs`` holds
    ``(prompt, served)`` token lists, each run over ``prompt +
    served[:-1]``; the result for it is ``(len(served), vocab_size)``
    float32 on ``device``, row j the logits that chose ``served[j]``.
    ``prefill_quantum`` is not read: the routing is dropless, so a token's
    experts do not depend on its chunk."""
    lay = layout(m)
    ops = R.Ops(precision)
    a, H = m["mla"], m["num_heads"]
    eps = m.get("norm_eps", 1e-6)
    theta = m.get("rope_theta", 10000.0)
    with R.NoTF32():
        toks = [list(p) + list(s[:-1]) for p, s in seqs]
        embed = W.draw(lay["embed"], seed, "embed", device)
        xs = [embed[torch.as_tensor(t, device=device)].float()
              for t in toks]
        del embed
        yarn = [_yarn(a, theta, x.shape[0], device) for x in xs]
        for i in range(m["num_layers"]):
            p = _layer_weights(lay, seed, i, device, ops)
            attn = {k: v for k, v in p.items() if k in (
                "wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo")}
            for j, x in enumerate(xs):
                x = x + _attention(R.rms_norm(x, p["ln1"], eps), attn, a, H,
                                   eps, *yarn[j], ops)
                h = R.rms_norm(x, p["ln2"], eps)
                if "router" in p:
                    x = x + _expert_layer(h, p, m, ops)
                else:
                    x = x + R.swiglu(h, p["w_gate"], p["w_up"], p["w_down"],
                                     ops)
                xs[j] = x
            del p, attn
        final = W.draw(lay["final_norm"], seed, "final_norm", device)
        head = ops.weight(W.draw(lay["lm_head"], seed, "lm_head", device))
        out = []
        for (prompt, served), x in zip(seqs, xs):
            logits = ops.mm(R.rms_norm(x, final, eps), head)
            out.append(logits[len(prompt) - 1:len(prompt) - 1 + len(served),
                              :m["vocab_size"]])
    return out
