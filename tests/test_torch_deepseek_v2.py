"""DeepSeek-V2 on the port (``engine/models/mla.py``, ``moe_share.py``, the
latent pool of ``kvcache.py``, ``kernels/latent_decode_attention``),
held against its plain float32 reference
(``engine/models/deepseek_v2_ref.py``) at the smoke size on the CPU.

Tolerances, each with its reason:

* the engine against the reference, float32: logits within 2e-4 of the
  logits' scale.  The port attends in the absorbed form at decode
  (``W_UK`` folded into the query, ``W_UV`` after the softmax) and over
  zero-padded heads at prefill, and sums the experts through grouped
  products: the same function as the reference's, summed in another
  order;
* the routing: the same experts, weights within 1e-6 (one softmax and one
  multiply in both);
* the shares against the whole layer, float32: within 1e-5 of its scale
  (sums of the same products in another order);
* the kernel's order of work, emulated here (tiles of 32 keys, an online
  softmax, probabilities rounded to bfloat16 for the value product),
  against the plain version: every element within 2e-3 + 8e-3 |ref| +
  3.125e-2 sqrt(sum_j p_j^2 v_j^2), the noise of probabilities rounded to
  bfloat16 (the flash kernel's rule); on the card the kernel
  (its output bfloat16 as well) against the plain version by the same
  rule, and with the last key dropped it must fail it.

The card's case is marked ``cuda`` and skips here; this file imports no
JAX.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.configs.base import MoEConfig, RoutingConfig  # noqa: E402
from repro_torch.configs.deepseek_v2 import (  # noqa: E402
    CONFIG, smoke_config)
from repro_torch.engine.engine import InferenceEngine  # noqa: E402
from repro_torch.engine.kvcache import PagedKVCache, kv_pair  # noqa: E402
from repro_torch.engine.models import deepseek_v2_ref as R  # noqa: E402
from repro_torch.engine.models import mla as MLA  # noqa: E402
from repro_torch.engine.models import moe_share as MS  # noqa: E402
from repro_torch.kernels.latent_decode_attention import (  # noqa: E402
    ops as ld_ops)
from repro_torch.kernels.latent_decode_attention.ref import (  # noqa: E402
    latent_decode_attention_ref)

F32 = dict(dtype="float32", param_dtype="float32")


def _weights(model, seed=1):
    """The model's state dict with every tensor drawn (norms around 0,
    scaled as 1 + w, so that they act)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in model.state_dict().items():
        std = 0.1 if v.dim() == 1 else (0.02 if k == "embed"
                                        else v.shape[-2] ** -0.5)
        out[k] = (torch.randn(v.shape, generator=g) * std).to(v.dtype)
    return out


def _engine(cfg, **kw):
    eng = InferenceEngine(cfg, seed=0, page_size=4, max_seq_len=96,
                          device="cpu", **kw)
    eng.load()
    sd = _weights(eng.model)
    eng.load(sd)
    return eng, sd


def _record(eng):
    """Record every logits row the engine's two entry points give, by
    call: ("prefill" | "decode", logits (B, Vpad))."""
    seen = []
    model = eng.model
    pf, dec = model.prefill_with_cache, model.paged_decode_step

    def prefill_with_cache(*a, **k):
        out = pf(*a, **k)
        seen.append(("prefill", out[0].clone()))
        return out

    def paged_decode_step(*a, **k):
        out = dec(*a, **k)
        seen.append(("decode", out[0].clone()))
        return out

    model.prefill_with_cache = prefill_with_cache
    model.paged_decode_step = paged_decode_step
    return seen


def _check_rows(cfg, sd, prompt, tokens, rows):
    """``rows`` (the logits that chose each of ``tokens``) against the
    reference's teacher-forced logits at the same positions."""
    ref = R.logits(cfg, sd, list(prompt) + list(tokens[:-1]))
    want = ref[len(prompt) - 1:]
    got = torch.stack([r[:cfg.vocab_size] for r in rows])
    scale = want.abs().max()
    assert (got - want).abs().max() <= 2e-4 * scale, \
        float((got - want).abs().max() / scale)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_engine_prefill_and_decode_match_the_reference(impl):
    """A prompt prefilled and then 8 decode steps through the engine's
    paged path (on the CPU the "cuda" impl takes the kernels' plain
    versions); then a second request that aliases the first one's prompt
    past a partial page, prefills its suffix over the aliased latents and
    decodes, the donor's copy-on-write page kept intact."""
    cfg = smoke_config().replace(attention_impl=impl, **F32)
    eng, sd = _engine(cfg, max_batch=4)
    seen = _record(eng)
    p1 = list(range(7, 30))                       # 23 tokens: a partial page
    out1 = eng.generate([p1], max_new_tokens=9)[0]
    assert [k for k, _ in seen] == ["prefill"] + ["decode"] * 8
    _check_rows(cfg, sd, p1, out1, [r[0] for _, r in seen])
    seen.clear()
    p2 = p1[:22] + [3, 5, 250, 11, 60]
    out2 = eng.generate([p2], max_new_tokens=9)[0]
    assert eng.stats.prefix_hits == 1 and eng.stats.prefill_tokens_saved == 22
    _check_rows(cfg, sd, p2, out2, [r[0] for _, r in seen])
    # the donor is still served right after its partial page was shared
    seen.clear()
    out3 = eng.generate([p1 + [1]], max_new_tokens=3)[0]
    _check_rows(cfg, sd, p1 + [1], out3, [r[0] for _, r in seen])
    eng.shutdown()


def test_batched_cold_prefill_matches_alone():
    """The cold prompts of one admission pass share a prefill call
    (``prefill_rows_independent``: the routing is dropless), and each
    row's logits are those of the prompt alone."""
    cfg = smoke_config().replace(attention_impl="torch", **F32)
    eng, sd = _engine(cfg, max_batch=4)
    assert eng.model.prefill_rows_independent and eng._batch_prefill
    seen = _record(eng)
    prompts = [[200 + n] + list(range(3, 3 + n)) for n in (5, 17, 30)]
    outs = eng.generate(prompts, max_new_tokens=4)
    assert eng.stats.prefill_rows == 3
    assert eng.stats.as_dict()["span_n.engine.admit.model"] == 1
    first = seen[0][1]
    assert seen[0][0] == "prefill" and first.shape[0] == 3
    for p, o in zip(prompts, outs):
        row = sorted(prompts, key=len).index(p)
        _check_rows(cfg, sd, p, o[:1], [first[row]])
    eng.shutdown()


def _routing_inputs(N=64, seed=3):
    cfg = smoke_config()
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(N, cfg.d_model, generator=g)
    router = torch.randn(cfg.d_model, cfg.moe.num_experts, generator=g) * 0.3
    return cfg, x, router


def test_routing_matches_the_reference():
    cfg, x, router = _routing_inputs()
    w, idx = MS.group_limited_topk(x, router, cfg.moe, cfg.routing)
    rw, ridx = R.route(x, router, cfg.moe, cfg.routing)
    assert torch.equal(idx, ridx)
    torch.testing.assert_close(w, rw, rtol=1e-6, atol=1e-6)
    # every chosen expert lies in one of the topk_group kept groups
    per = cfg.moe.num_experts // cfg.routing.n_group
    groups = idx // per
    assert all(len(set(r)) <= cfg.routing.topk_group for r in groups.tolist())


def test_group_limit_changes_the_chosen_experts():
    """A token whose plain top-k spans more groups than ``topk_group``:
    the gate keeps the best groups and takes its remaining experts there,
    as the reference does."""
    cfg, _, _ = _routing_inputs()
    E, G = cfg.moe.num_experts, cfg.routing.n_group        # 16 in 4 of 4
    logits = torch.full((1, E), -4.0)
    # group 0 holds the best expert, groups 1 and 2 one good expert each,
    # group 3 three fair ones: the plain top-3 is {0, 4, 8}, but groups 1
    # and 2 score 2.0 and 1.9 against group 3's 1.5 -> keep {0, 1}
    logits[0, [0, 4, 8]] = torch.tensor([3.0, 2.0, 1.9])
    logits[0, [12, 13, 14]] = 1.5
    router = torch.linalg.pinv(torch.eye(cfg.d_model)[:1]) @ logits
    x = torch.eye(cfg.d_model)[:1]
    plain = torch.topk(torch.softmax(x @ router, -1), cfg.moe.top_k).indices
    w, idx = MS.group_limited_topk(x, router, cfg.moe, cfg.routing)
    rw, ridx = R.route(x, router, cfg.moe, cfg.routing)
    assert sorted(plain[0].tolist()) == [0, 4, 8]
    assert sorted(idx[0].tolist()) != [0, 4, 8]
    assert torch.equal(idx, ridx)
    assert set(idx[0].tolist()) <= set(range(8))            # groups 0 and 1
    torch.testing.assert_close(w, rw, rtol=1e-6, atol=1e-6)


def _layer_params(held_start, held_count, whole):
    """One expert layer's parameters for the share ``held_start ..
    +held_count``, sliced from the whole layer's ``whole``."""
    sl = slice(held_start, held_start + held_count)
    return {"router": whole["router"],
            "w_gate": whole["w_gate"][sl], "w_up": whole["w_up"][sl],
            "w_down": whole["w_down"][sl],
            "shared": {k: whole["shared." + k]
                       for k in ("w_gate", "w_up", "w_down")}}


def test_the_shares_add_up_to_the_whole_layer():
    """The model-configs guide's share test: the parts of 8 shares of 2
    experts each, the shared experts counted once, add up to the uncut
    layer's result, through the port and through the reference."""
    cfg = smoke_config()
    E, D, Fe = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    g = torch.Generator().manual_seed(11)
    fs = cfg.moe.num_shared_experts * Fe
    whole = {"router": torch.randn(D, E, generator=g) * D ** -0.5,
             "w_gate": torch.randn(E, D, Fe, generator=g) * D ** -0.5,
             "w_up": torch.randn(E, D, Fe, generator=g) * D ** -0.5,
             "w_down": torch.randn(E, Fe, D, generator=g) * Fe ** -0.5,
             "shared.w_gate": torch.randn(D, fs, generator=g) * D ** -0.5,
             "shared.w_up": torch.randn(D, fs, generator=g) * D ** -0.5,
             "shared.w_down": torch.randn(fs, D, generator=g) * fs ** -0.5}
    x = torch.randn(2, 9, D, generator=g)
    shared = R.swiglu(x.view(-1, D), whole["shared.w_gate"],
                      whole["shared.w_up"], whole["shared.w_down"])
    n, per = 8, E // 8
    parts, ref_parts = [], []
    for s in range(n):
        routing = dataclasses.replace(cfg.routing, held_start=s * per,
                                      held_count=per)
        p = _layer_params(s * per, per, whole)
        parts.append(MS.share_ffn(x, p, cfg.moe, routing).view(-1, D))
        ref_parts.append(R.expert_layer(
            x.view(-1, D), {**{k: p[k] for k in ("router", "w_gate", "w_up",
                                                  "w_down")},
                            **{"shared." + k: v
                               for k, v in p["shared"].items()}},
            cfg.moe, routing, s * per, per))
    everything = dataclasses.replace(cfg.routing, held_start=0, held_count=0)
    full = MS.share_ffn(x, _layer_params(0, E, whole), cfg.moe,
                        everything).view(-1, D)
    ref_full = R.expert_layer(x.view(-1, D), whole, cfg.moe, everything, 0, E)
    scale = ref_full.abs().max()
    for got, want in ((sum(parts) - (n - 1) * shared, full),
                      (sum(ref_parts) - (n - 1) * shared, ref_full),
                      (full, ref_full)):
        assert (got - want).abs().max() <= 1e-5 * scale


def test_share_counts_held_slots_and_leaves_padding_out():
    """``slots_held`` sums the held slots on the device; rows marked
    invalid compute no routed product (their result is the shared
    experts' alone)."""
    cfg = smoke_config()
    _, x, router = _routing_inputs(N=12)
    m = MLA.MLATransformerLM(cfg.replace(**F32), device="cpu")
    p = m.blocks[1].moe
    with torch.no_grad():
        for name, t in _weights(m).items():
            if name.startswith("blocks.1.moe."):
                p.get_parameter(name[len("blocks.1.moe."):]).copy_(t)
        p.router.copy_(router)
    x = x.view(3, 4, -1)
    valid = torch.tensor([[True] * 4, [True, True, False, False],
                          [False] * 4])
    slots = torch.zeros((), dtype=torch.int64)
    y = MS.share_ffn(x, p, cfg.moe, cfg.routing, valid=valid,
                     slots_held=slots)
    _, idx = MS.group_limited_topk(x.view(-1, x.shape[-1]), router, cfg.moe,
                                   cfg.routing)
    held = (idx < cfg.routing.held_count) & valid.view(-1, 1)
    assert int(slots) == int(held.sum())
    shared_only = y.view(-1, x.shape[-1])[~valid.view(-1)]
    want = MS.L.ffn_apply(p["shared"], x.view(-1, x.shape[-1])[~valid.view(-1)])
    torch.testing.assert_close(shared_only, want)


@pytest.mark.parametrize("heads", [None, 2], ids=["one_plane",
                                                  "two_planes"])
def test_latent_pool_aliasing_and_copy_on_write(heads):
    """One code path over the planes a pool holds: one (L, P, page, D)
    tensor and no V (the latent pool), or K and V of (L, P, page, H, D).
    A sequence aliases a donor's pages up to a partial page, its first
    append copies that page in every plane, and the donor's rows stay as
    they were; the bytes are the planes'.  Only a (K, V) pool's sequences
    migrate."""
    L, D, ps = 3, 24, 4
    row = (D,) if heads is None else (heads, D)
    planes = 1 if heads is None else 2
    kv = PagedKVCache(L, 16, ps, heads, D, device="cpu")
    assert kv.k.shape == (L, 16, ps) + row
    assert (kv.v is None) == (planes == 1)
    assert kv.hbm_bytes() == planes * L * 16 * ps * math.prod(row) * 4
    g = torch.Generator().manual_seed(0)

    def rows(n):
        return kv_pair([torch.randn((L, n) + row, generator=g)
                        for _ in range(planes)])

    def same(got, want):
        return all((x is None and y is None) or torch.equal(x, y)
                   for x, y in zip(got, want))

    a = rows(10)
    donor = kv.add_sequence(*a)
    assert same(kv.gather(donor), a)
    seq = kv.add_sequence(shared_from=donor, shared_len=10)
    assert kv.sequences[seq].page_ids == kv.sequences[donor].page_ids
    b = rows(5)
    kv.extend_sequence(seq, *b)
    assert kv.sequences[seq].page_ids[2] != kv.sequences[donor].page_ids[2]
    assert same(kv.gather(donor), a)
    assert same(kv.gather(seq), kv_pair(
        [torch.cat([x, y], dim=1) for x, y in zip(a[:planes], b)]))
    p, slot = kv.prepare_append(donor)
    assert (p, slot) == (kv.sequences[donor].page_ids[2], 2)
    kv.free_sequence(seq)
    kv.free_sequence(donor)
    assert kv.pages_in_use == 0
    seq = kv.add_sequence(*a)
    if planes == 1:
        with pytest.raises(NotImplementedError):
            kv.export_sequence(seq)
    else:
        assert same([torch.from_numpy(x) for x in kv.export_sequence(seq)],
                    a)


def test_the_engine_counts_the_expert_layer_and_nothing_new_elsewhere():
    """The latent model's counters appear in ``as_dict()``; a model
    without them (qwen3's smoke) reads the same keys as before."""
    from repro_torch.configs import get_smoke
    cfg = smoke_config().replace(attention_impl="torch", **F32)
    eng, _ = _engine(cfg, max_batch=2)
    eng.generate([list(range(5, 15))], max_new_tokens=3)
    d = eng.stats.as_dict()
    n_moe = cfg.num_layers - cfg.moe.first_dense_layers
    assert d["moe_layer_calls"] == n_moe * 3      # one prefill, two steps
    assert 0 < d["expert_slots_held"] <= 12 * cfg.moe.top_k * n_moe
    assert d["latent_decode_launches"] == ld_ops.launches
    eng.shutdown()
    dense = InferenceEngine(get_smoke("qwen3-1.7b"), device="cpu")
    assert not {"moe_layer_calls", "expert_slots_held",
                "latent_decode_launches"} & set(dense.stats.as_dict())


def test_out_of_scope_paths_raise():
    cfg = smoke_config().replace(attention_impl="torch", **F32)
    with pytest.raises(NotImplementedError):
        InferenceEngine(cfg, device="cpu", paged_decode=False)
    eng, _ = _engine(cfg, max_batch=2)
    with pytest.raises(NotImplementedError):
        eng.model.loss_fn({"tokens": torch.zeros(1, 4, dtype=torch.long)})
    eng.generate([list(range(5, 15))], max_new_tokens=2)
    with pytest.raises(NotImplementedError):
        eng.export_prefix(list(range(5, 15)))
    eng.shutdown()


def test_registries_are_untouched():
    """DeepSeek-V2 stays out of the registry of the JAX package's ten, and
    its settings went into dataclasses of their own, not MoEConfig."""
    assert len(ARCH_IDS) == 10 and "deepseek-v2" not in ARCH_IDS
    assert [f.name for f in dataclasses.fields(MoEConfig)] == [
        "num_experts", "top_k", "d_ff_expert", "num_shared_experts",
        "first_dense_layers", "d_ff_dense", "capacity_factor",
        "router_aux_weight"]
    assert CONFIG.routing == RoutingConfig(
        n_group=8, topk_group=3, routed_scaling_factor=16.0,
        norm_topk_prob=False, held_start=0, held_count=20)


def test_yarn_at_the_published_settings():
    """The correction range of beta_fast 32 / beta_slow 1 over 4096
    positions at theta 1e4, 64 rotary dims: frequency pairs 0-10 keep the
    original frequencies, 23-31 take the interpolated ones, those between
    a blend of the two; the score scale
    is 0.1 * 0.707 * ln 40 + 1 squared over sqrt(192)."""
    a = CONFIG.mla
    inv = MLA.yarn_inv_freq(a, CONFIG.rope_theta)
    base = CONFIG.rope_theta ** (torch.arange(0, 64, 2) / 64.0)
    torch.testing.assert_close(inv[:11], 1.0 / base[:11])
    torch.testing.assert_close(inv[23:], 1.0 / (40.0 * base[23:]))
    assert ((inv[11:23] < 1.0 / base[11:23])
            & (inv[11:23] > 1.0 / (40 * base[11:23]))).all()
    m = 0.1 * 0.707 * torch.log(torch.tensor(40.0)).item() + 1.0
    assert MLA.softmax_scale(a) == pytest.approx(m * m / 192 ** 0.5)
    assert MLA.rope_cos_scale(a) == 1.0


def _case(B=6, H=64, D=576, ps=8, ctx=80, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(0, ctx, (B,), generator=g, dtype=torch.int32)
    lengths[0] = -1
    n_pages = ctx // ps + 1
    pt = torch.randperm(B * n_pages + 3, generator=g)[:B * n_pages] \
        .view(B, n_pages).to(torch.int32)
    pool = torch.randn(B * n_pages + 3, ps, D, generator=g).bfloat16().float()
    q = (torch.randn(B, H, D, generator=g) * 0.5).bfloat16()
    return [t.to(device) for t in (q, pool, pt, lengths)]


def _emulate_kernel(q, pool, pt, lengths, scale, v_dim, tile=32):
    """The kernel's order of work: 32 keys a tile, an online softmax, the
    probabilities rounded to bfloat16 for the value product and summed
    as rounded."""
    B, H, _ = q.shape
    out = torch.zeros(B, H, v_dim)
    for b in range(B):
        n = int(lengths[b]) + 1
        if n <= 0:
            continue
        keys = pool[pt[b].long()].reshape(-1, pool.shape[-1])[:n].float()
        m = torch.full((H,), float("-inf"))
        l = torch.zeros(H)
        acc = torch.zeros(H, v_dim)
        for k0 in range(0, n, tile):
            s = q[b].float() @ keys[k0:k0 + tile].T * scale
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[:, None]).bfloat16().float()
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[:, None] + p @ keys[k0:k0 + tile, :v_dim]
            m = m_new
        out[b] = acc / l[:, None]
    return out


def _tolerance(q, pool, pt, lengths, scale, v_dim):
    """The plain version's output and the rule a bfloat16 result is held
    to: 2e-3 + 8e-3 |ref| + 3.125e-2 sqrt(sum_j p_j^2 v_j^2), the last the
    noise of probabilities rounded to bfloat16 (the flash kernel's rule,
    tests/test_torch_cuda.py)."""
    ref = latent_decode_attention_ref(q.float(), pool, pt, lengths,
                                      scale=scale, v_dim=v_dim).float()
    B, n_pages = pt.shape
    keys = pool[pt.long()].reshape(B, -1, pool.shape[-1]).float()
    logits = torch.einsum("bhd,btd->bht", q.float(), keys) * scale
    t = torch.arange(keys.shape[1], device=q.device)
    valid = t[None, :] <= lengths[:, None].long()
    p = torch.softmax(logits.masked_fill(~valid[:, None], float("-inf")), -1)
    p = torch.nan_to_num(p)
    noise = torch.einsum("bht,btd->bhd", p.square(),
                         keys[..., :v_dim].square()).sqrt()
    return ref, 2e-3 + 8e-3 * ref.abs() + 3.125e-2 * noise


def test_the_kernels_order_of_work_matches_the_plain_version():
    q, pool, pt, lengths = _case()
    ref, tol = _tolerance(q, pool, pt, lengths, 0.11, 512)
    emu = _emulate_kernel(q, pool, pt, lengths, 0.11, 512)
    assert ((emu - ref).abs() <= tol).all()
    assert (ref[0] == 0).all()
    # the CPU path of the wrapper is the plain version
    assert torch.equal(ld_ops.latent_decode_attention(
        q, pool, pt, lengths, scale=0.11, v_dim=512),
        latent_decode_attention_ref(q, pool, pt, lengths, scale=0.11,
                                    v_dim=512))
    with pytest.raises(ValueError):
        ld_ops.latent_decode_attention(q, pool[:, :, :100], pt, lengths,
                                       scale=0.11, v_dim=512)


@pytest.mark.cuda
def test_the_kernel_on_the_card():
    """The kernel against its plain version at the cell's widths (128
    heads, the latent 576/512, page 8, contexts up to 608), a padding row
    zero, and with each row's last key dropped the rule fails."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    q, pool, pt, lengths = _case(B=48, H=128, ctx=608, device="cuda")
    before = ld_ops.launches
    out = ld_ops.latent_decode_attention(q, pool, pt, lengths, scale=0.11,
                                         v_dim=512)
    torch.cuda.synchronize()
    assert ld_ops.launches == before + 1 and out.dtype == torch.bfloat16
    ref, tol = _tolerance(q, pool, pt, lengths, 0.11, 512)
    assert ((out.float() - ref).abs() <= tol).all()
    assert (out[0] == 0).all()
    short = torch.where(lengths > 0, lengths - 1, lengths)
    cut = ld_ops.latent_decode_attention(q, pool, pt, short, scale=0.11,
                                         v_dim=512)
    assert ((cut.float() - ref).abs() > tol).any()


def test_a_wide_batch_does_not_rebuild_the_prefix_tree_every_retirement():
    """With more rows in flight than eight times the warm set, the radix
    tree is rebuilt once its stale entries pass the live ones, not on
    every retirement (which at 768 rows cost seconds a wave)."""
    from repro_torch.configs import get_smoke
    eng = InferenceEngine(get_smoke("qwen3-1.7b"), max_batch=24,
                          max_warm_sequences=1, max_seq_len=64,
                          device="cpu")
    prompts = [[100 + i] + list(range(5, 12)) for i in range(24)]
    hs = [eng.submit(p, max_new_tokens=2 + i % 12) for i, p in
          enumerate(prompts)]
    for h in hs:
        h.result()
    assert eng.stats.peak_batch == 24
    # before, every retirement past the eighth rebuilt: 17 times
    assert eng.stats.tree_rebuilds <= 2
    eng.shutdown()
