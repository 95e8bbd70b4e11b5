"""The plain reference against the port, in float32 on the CPU: the
teacher-forced forward, and prefill then decode through the engine's
paged cache (prefix aliasing and the MoE capacity clamp included)."""
import copy

import pytest
import torch

from portbench.harness.cell import model_config
from portbench.reference import weights as W
from portbench.reference.model import served_logits
from portbench.tests.fixtures import DENSE, MOE

pytest.importorskip("repro_torch")


def f32(m, **kw):
    m = copy.deepcopy(m)
    m.update(dtype="float32", param_dtype="float32", **kw)
    return m


def port_model(m, seed):
    from repro_torch.engine.models import build_model
    model = build_model(model_config(m), device="cpu")
    W.fill_params(model.named_parameters(), m, seed)
    return model


@pytest.mark.parametrize("m", [f32(DENSE), f32(MOE)], ids=["dense", "moe"])
@pytest.mark.parametrize("T", [16, 48])
def test_teacher_forced_last_row(m, T):
    """At a prompt of a whole number of quanta the port's forward routes
    the sequence as the reference routes a prompt (one group, the same
    capacity, which binds here: 8 experts, top-2, factor 1.25)."""
    seed = 3 + T
    toks = torch.randint(0, 250, (1, T), generator=torch.Generator()
                         .manual_seed(T))
    logits, _ = port_model(m, seed).forward(toks, impl="torch")
    ref = served_logits(m, seed, [(toks[0].tolist(), [0])], device="cpu")[0]
    assert torch.allclose(ref[0], logits[0, -1, :m["vocab_size"]],
                          atol=2e-4, rtol=1e-4)


def test_teacher_forced_every_row_dense():
    m, seed = f32(DENSE), 5
    toks = torch.randint(0, 250, (1, 40), generator=torch.Generator()
                         .manual_seed(1))
    logits, _ = port_model(m, seed).forward(toks, impl="torch")
    prompt, served = toks[0, :10].tolist(), toks[0, 10:].tolist() + [0]
    ref = served_logits(m, seed, [(prompt, served)], device="cpu")[0]
    assert torch.allclose(ref, logits[0, 9:, :m["vocab_size"]], atol=2e-4,
                          rtol=1e-4)


def _engine_rows(m, seed, prompts, max_new):
    """The logits the engine sampled each served token from, per prompt
    (one request at a time, so row 0 of each call is the request's)."""
    from repro_torch.engine.engine import InferenceEngine
    eng = InferenceEngine(model_config(m), seed=seed, max_batch=1,
                          page_size=8, num_pages=128, device="cpu")
    eng.model.to_empty(device="cpu")
    W.fill_params(eng.model.named_parameters(), m, seed)
    eng.load(eng.model.state_dict())
    rows = []
    model = eng.model
    pre, dec = model.prefill_with_cache, model.paged_decode_step

    def prefill(*a, **kw):
        out = pre(*a, **kw)
        rows.append(out[0][0, :m["vocab_size"]].clone())
        return out

    def decode(*a, **kw):
        out = dec(*a, **kw)
        rows.append(out[0][0, :m["vocab_size"]].clone())
        return out

    model.prefill_with_cache, model.paged_decode_step = prefill, decode
    served, per = [], []
    try:
        for p in prompts:
            start = len(rows)
            served.append(eng.generate([p], max_new_tokens=max_new)[0])
            per.append(torch.stack(rows[start:]))
    finally:
        eng.shutdown()
    return served, per, eng.stats


@pytest.mark.parametrize("m", [f32(DENSE), f32(MOE)], ids=["dense", "moe"])
def test_prefill_then_decode_through_the_cache(m):
    seed = 9
    g = torch.Generator().manual_seed(2)
    shared = torch.randint(0, 250, (24,), generator=g).tolist()
    prompts = [torch.randint(0, 250, (n,), generator=g).tolist()
               for n in (37, 21)]
    if m["family"] == "dense":
        # the second call aliases the first's pages for its 24 tokens
        prompts = [shared + prompts[0], shared + prompts[1]]
    served, rows, stats = _engine_rows(m, seed, prompts, max_new=7)
    if m["family"] == "dense":
        assert stats.prefill_tokens_saved > 0
    ref = served_logits(m, seed, list(zip(prompts, served)), device="cpu")
    for r, port in zip(ref, rows):
        assert torch.allclose(r, port, atol=2e-4, rtol=1e-4)


def test_layout_is_the_ports_checkpoint():
    from repro_torch.engine.models import build_model
    for m in (DENSE, MOE):
        model = build_model(model_config(m), device="meta")
        lay = W.layout(m)
        got = {n: (tuple(p.shape), str(p.dtype).split(".")[1])
               for n, p in model.named_parameters()}
        assert got == {k: (s, dt) for k, (s, dt, _) in lay.items()}


def test_one_tensor_made_alone_equals_the_fill():
    m = DENSE
    model = port_model(m, 17)
    p = dict(model.named_parameters())
    for key in ("blocks.1.attn.wk", "lm_head", "blocks.0.ln2"):
        assert torch.equal(W.make(m, 17, key, "cpu"), p[key])
    assert not torch.equal(W.make(m, 18, "lm_head", "cpu"), p["lm_head"])
