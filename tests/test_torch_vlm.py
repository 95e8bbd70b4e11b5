"""The port's VLM (internvl2-2b) against the JAX package's, on the CPU.

``get_smoke("internvl2-2b")`` in float32 (3 layers, d_model 64, 4 / 2
heads of 16, 8 patches, an untied head) is made by the JAX init and
bridged into the port's ``TransformerLM``.  The stub frontend's patch
embeddings ``prefix_embeds`` (B, P, d_model), drawn from numpy seeds, lead
the sequence at positions 0..P-1: forward, prefill (its cache holds P + S
rows) and decode steps from P + S on equal JAX's to 1e-4, with and
without the prefix.  ``InferenceEngine`` serves requests that carry
``patch_embeds`` (one full prefill each, pages for P + S + max_new, never
shared or coalesced) beside text-only ones that share a prefix, on the
paged path and on the dense view, and gives the JAX engine's greedy
tokens and counters request for request.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.engine.models import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.engine.engine import InferenceEngine  # noqa: E402
from repro_torch.engine.models import build_model  # noqa: E402

ARCH = "internvl2-2b"
P = 8                                        # the smoke config's patches


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU shapes gain nothing from torch's thread pool, and its
    spinning threads would slow the tests other workers run meanwhile."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(t, j, tol=1e-4):
    a = t.float().numpy()
    b = np.asarray(j, np.float32)
    np.testing.assert_allclose(a, b, atol=tol * max(1.0, np.abs(b).max()),
                               rtol=tol)


def _patches(seed, B=1):
    return (0.5 * np.random.default_rng(seed).normal(
        size=(B, P, 64))).astype(np.float32)


# ------------------------------------------------------------------ model

@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke(ARCH).replace(dtype="float32")
    cfg = get_smoke(ARCH).replace(dtype="float32")
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), cfg))
    return jm, jp, tm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_of_every_leaf(dtype):
    """The VLM's tree is the dense tree: every JAX leaf lands in the port
    at its shape, in the model dtype, with its values, the untied head
    included, and the port has no other parameter."""
    jcfg = jax_smoke(ARCH).replace(dtype=dtype)
    cfg = get_smoke(ARCH).replace(dtype=dtype)
    jp = jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.PRNGKey(2)))
    tm = build_model(cfg, device="cpu")
    sd = params_from_jax(jp, cfg)
    tm.load_state_dict(sd)
    mine = dict(tm.named_parameters())
    expect = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [p.key for p in path]
        if keys[0] == "blocks":
            for i in range(leaf.shape[0]):
                expect[".".join(["blocks", str(i), *keys[1:]])] = leaf[i]
        else:
            expect[".".join(keys)] = leaf
    assert set(expect) == set(mine) == set(sd)
    assert "lm_head" in mine and not cfg.tie_embeddings
    for name, leaf in expect.items():
        t = mine[name]
        assert tuple(t.shape) == leaf.shape, name
        assert t.dtype == getattr(torch, dtype), name
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(leaf, np.float32))


@pytest.mark.parametrize("with_prefix", [True, False])
def test_forward_prefill_and_decode_step_match_jax(models, with_prefix):
    jm, jp, tm = models
    B, S = 2, 7
    toks = np.random.default_rng(3).integers(0, 256, (B, S)).astype(
        np.int32)
    pe = _patches(4, B) if with_prefix else None
    jpe = None if pe is None else jnp.asarray(pe)
    tpe = None if pe is None else torch.from_numpy(pe)
    n_pre = P if with_prefix else 0
    jf, _ = jm.forward(jp, jnp.asarray(toks), prefix_embeds=jpe)
    tf, aux = tm.forward(torch.from_numpy(toks), prefix_embeds=tpe)
    assert tf.shape[1] == S + n_pre
    _close(tf, jf)
    assert float(aux) == 0.0
    jl, jc = jm.prefill(jp, jnp.asarray(toks), prefix_embeds=jpe)
    tl, tc = tm.prefill(torch.from_numpy(toks), prefix_embeds=tpe)
    _close(tl, jl)
    assert tc["k"].shape[2] == S + n_pre
    assert tc["length"].tolist() == [S + n_pre] * B
    for key in ("k", "v"):
        _close(tc[key], jc[key])
    # decode from P + S on, over the cache grown by 4 slots
    jc = jm.extend_cache(jc, 4)
    pad = (0, 0, 0, 0, 0, 4)
    tc = dict(tc, k=torch.nn.functional.pad(tc["k"], pad),
              v=torch.nn.functional.pad(tc["v"], pad))
    for i in range(3):
        tok = np.asarray([(9 * i + 4) % 256, (5 * i + 7) % 256], np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(tok), jc)
        tl, tc = tm.decode_step(torch.from_numpy(tok), tc)
        _close(tl, jl)


def test_the_prefix_acts_through_attention_only_from_its_rows(models):
    """Text tokens after the patches see them: the last position's logits
    move with the patches, and a forward over [patches, tokens] at the
    text positions equals the prefill's last logits."""
    _, _, tm = models
    toks = torch.arange(20, 26)[None]
    a, _ = tm.prefill(toks, prefix_embeds=torch.from_numpy(_patches(5)))
    b, _ = tm.prefill(toks, prefix_embeds=torch.from_numpy(_patches(6)))
    assert (a - b).abs().max() > 1e-3
    full, _ = tm.forward(toks, prefix_embeds=torch.from_numpy(_patches(5)))
    torch.testing.assert_close(full[:, -1], a, atol=1e-5, rtol=1e-5)


# ----------------------------------------------------------------- engine

PREFIX = list(range(10, 30))                     # 20 tokens: 2.5 pages
PROMPTS = {"img_a": list(range(40, 51)), "text_a": PREFIX + [100, 101],
           "img_b": [3, 4, 5], "text_b": PREFIX + [102],
           "img_a_dup": list(range(40, 51)), "text_b_dup": PREFIX + [102]}
STATS = ("prefix_hits", "tokens_reused", "pages_shared",
         "coalesced_requests", "prefill_tokens", "prefill_tokens_saved")


def _extras():
    a = _patches(7)
    return {"img_a": {"patch_embeds": a}, "img_a_dup": {"patch_embeds": a},
            "img_b": {"patch_embeds": _patches(8)}}


def _scenario(eng, late_patches=None):
    extras = _extras()
    names = list(PROMPTS)
    out = {"tokens": dict(zip(names, eng.generate(
        [PROMPTS[n] for n in names], max_new_tokens=5,
        extras=[extras.get(n, {}) for n in names])))}
    out["stats"] = {k: getattr(eng.stats, k) for k in STATS}
    # a patch request admitted mid-decode
    n0 = eng.stats.decode_tokens
    h1 = eng.submit(list(range(60, 75)), max_new_tokens=12)
    deadline = time.monotonic() + 120
    while eng.stats.decode_tokens <= n0:
        assert time.monotonic() < deadline, "no decode step"
        time.sleep(0.002)
    pe = _patches(9)
    if late_patches is not None:
        pe = late_patches(pe)
    h2 = eng.submit([7, 8, 9, 10], max_new_tokens=4,
                    extra={"patch_embeds": pe})
    out["mid"] = (h1.result(), h2.result())
    return out


@pytest.fixture(scope="module")
def weights():
    eng = JaxEngine(jax_smoke(ARCH).replace(dtype="float32"), seed=0)
    eng.load()
    cfg = get_smoke(ARCH).replace(dtype="float32")
    return eng, cfg, params_from_jax(jax.tree.map(np.asarray, eng.params),
                                     cfg)


@pytest.fixture(scope="module")
def jax_run(weights):
    eng = weights[0]
    try:
        return _scenario(eng)
    finally:
        eng.shutdown()


@pytest.mark.parametrize("paged", [True, False])
def test_patch_requests_give_the_jax_engine_s_tokens(weights, jax_run,
                                                     paged):
    """On the paged path and on the dense view: the JAX engine's tokens and
    counters; the text pair shares its prefix and the text duplicate
    coalesces, the patch duplicate does neither; every patch row counts as
    prefilled."""
    _, cfg, sd = weights
    eng = InferenceEngine(cfg, seed=0, device="cpu", paged_decode=paged)
    eng.load(sd)
    try:
        # tensors, as well as numpy arrays, are moved to the engine
        out = _scenario(eng, late_patches=(
            None if paged else lambda a: torch.from_numpy(a)))
        assert eng.stats.view_rebuilds == 0 if paged \
            else eng.stats.view_rebuilds >= 2
        eng.release_warm()
        assert eng.kv.pages_in_use == 0
    finally:
        eng.shutdown()
    assert out == jax_run
    tok, st = out["tokens"], out["stats"]
    assert tok["img_a"] == tok["img_a_dup"]
    assert tok["text_b"] == tok["text_b_dup"]
    assert st["coalesced_requests"] == 1 and st["prefix_hits"] >= 1
    assert st["prefill_tokens"] + st["prefill_tokens_saved"] \
        == sum(map(len, PROMPTS.values())) - len(PROMPTS["text_b_dup"]) \
        + 3 * P


def test_patches_change_the_tokens_and_count_as_prefill(weights):
    """The same prompt with and without patches decodes differently, and
    the patch request's prefill counts its P patch rows."""
    _, cfg, sd = weights
    eng = InferenceEngine(cfg, seed=0, device="cpu", page_size=4)
    eng.load(sd)
    try:
        prompt = list(range(40, 51))
        text = eng.generate([prompt], max_new_tokens=6)[0]
        h = eng.submit(prompt, max_new_tokens=6,
                       extra={"patch_embeds": _patches(7)})
        img = h.result()
        assert img != text
        assert eng.stats.prefill_tokens == 2 * len(prompt) + P
    finally:
        eng.shutdown()
