"""The port's MoE family against the JAX package's, on the CPU.

``moe_ffn`` runs on the same bridged weights and inputs in both packages:
output and aux loss within 1e-5 (float32), the keep masks (which routed
slots an expert's capacity drops) exactly, over groupings that fall
through ``N % G`` and past 16 groups, with and without drops and shared
experts.  ``get_smoke("deepseek-moe-16b")`` (a dense lead layer, then MoE
layers, shared experts, untied head) is held against the JAX
``TransformerLM`` (logits within 1e-4) and, through ``InferenceEngine``,
against the JAX engine's greedy tokens on the paged path and the dense
view.  The reference's capacity is per group and a prefill chunk is one
group, so the tokens a warm (prefix-shared) admission gives may differ
from a cold one's: the port must follow that, path for path.
"""
import contextlib
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.configs.base import MoEConfig as JaxMoEConfig  # noqa: E402
from repro.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.engine.models import build_model as jax_build  # noqa: E402
from repro.engine.models import moe as jax_moe  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.engine.engine import InferenceEngine  # noqa: E402
from repro_torch.engine.models import build_model  # noqa: E402
from repro_torch.engine.models import moe  # noqa: E402

ARCH = "deepseek-moe-16b"
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU shapes gain nothing from torch's thread pool, and its
    spinning threads would slow the tests other workers run meanwhile."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tensors(tree):
    return {k: (_tensors(v) if isinstance(v, dict)
                else torch.from_numpy(np.asarray(v, np.float32).copy()))
            for k, v in tree.items()}


@contextlib.contextmanager
def _routing():
    """Collect one entry per ``moe_ffn`` call from what the port's
    ``_dispatch_indices`` takes and gives: ``tokens`` (G*Ng), ``groups``,
    ``capacity``, ``top_i`` (G, Ng, K), ``keep`` and ``dropped``, the
    routed slots past their expert's capacity.  Calls from an engine's
    loop thread are collected too."""
    rec, inner = [], moe._dispatch_indices

    def spy(top_idx, num_experts, capacity):
        pos, keep = inner(top_idx, num_experts, capacity)
        G, Ng = top_idx.shape[:2]
        rec.append({"tokens": G * Ng, "groups": G, "capacity": capacity,
                    "top_i": top_idx, "keep": keep,
                    "dropped": int((~keep).sum())})
        return pos, keep

    moe._dispatch_indices = spy
    try:
        yield rec
    finally:
        moe._dispatch_indices = inner


def _jax_keep(x, p, cfg, groups):
    """The reference's keep mask (G, Ng, K), from its own routing and
    ``_dispatch_indices``."""
    B, S, D = x.shape
    N = B * S
    Ng = N // groups
    cap = max(int(np.ceil(Ng * cfg.top_k / cfg.num_experts
                          * cfg.capacity_factor)), cfg.top_k)

    def keep(xg):
        probs = jax.nn.softmax(xg.astype(jnp.float32) @ p["router"], -1)
        top_i = jax.lax.top_k(probs, cfg.top_k)[1]
        return jax_moe._dispatch_indices(top_i, cfg.num_experts, cap)[1]

    return np.asarray(jax.vmap(keep)(jnp.asarray(x).reshape(groups, Ng, D)))


# (B, S, capacity factor, groups): no drops at cf 64; one group of 32
# tokens clamped at cf 1.0; then B = 1, 3, 8 and 17, where G = min(B, 16)
# falls to 5 (85 tokens)
CASES = {"no_drops": (2, 8, 64.0, 2), "clamp": (1, 32, 1.0, 1),
         "B1": (1, 5, 1.25, 1), "B3": (3, 5, 1.25, 3),
         "B8": (8, 5, 1.25, 8), "B17": (17, 5, 1.25, 5)}


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_output_aux_and_keep_mask_equal_jax(case, shared):
    B, S, cf, groups = CASES[case]
    D = 16
    kw = dict(num_experts=8, top_k=2, d_ff_expert=24,
              num_shared_experts=shared, capacity_factor=cf)
    jcfg, cfg = JaxMoEConfig(**kw), MoEConfig(**kw)
    jp = jax_moe.moe_init(jax.random.PRNGKey(0), D, jcfg, jnp.float32)
    x = np.random.default_rng(1).normal(size=(B, S, D)).astype(np.float32)
    jy, jaux = jax_moe.moe_ffn(jnp.asarray(x), jp, jcfg)
    with _routing() as rec:
        y, aux = moe.moe_ffn(torch.from_numpy(x), _tensors(jp), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), atol=TOL, rtol=TOL)
    assert aux.dtype == torch.float32
    (entry,) = rec
    assert entry["groups"] == groups and entry["tokens"] == B * S
    jkeep = _jax_keep(x, jp, jcfg, groups)
    np.testing.assert_array_equal(entry["keep"].numpy(), jkeep)
    assert entry["dropped"] == int((~jkeep).sum())
    if case == "no_drops":
        assert jkeep.all()
    if case == "clamp":
        assert entry["capacity"] == 8 and not jkeep.all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropped_slots_add_exactly_zero_and_output_keeps_the_dtype(dtype):
    """The port's pin of the reference's strict-promotion fix: the keep
    mask is cast before the combine multiplies by it.  A router that sends
    every token to experts 0 and 1 fills their capacity with the first
    tokens; each later token has both slots dropped and gets exactly 0."""
    E, D, N = 4, 16, 12
    cfg = MoEConfig(num_experts=E, top_k=2, d_ff_expert=8)
    p = moe.moe_init(torch.Generator().manual_seed(0), D, cfg, dtype)
    p["router"] = torch.zeros(D, E)
    p["router"][:, :2] = 50.0
    x = torch.rand(1, N, D, generator=torch.Generator().manual_seed(1)) \
        .to(dtype) + 0.1
    with _routing() as rec:
        y, _ = moe.moe_ffn(x, p, cfg)
    cap = rec[0]["capacity"]
    assert cap == 8 and rec[0]["dropped"] == 2 * (N - cap)
    assert y.dtype == dtype and y.shape == x.shape
    assert torch.all(y[0, cap:] == 0)
    assert torch.all(y[0, :cap].abs().sum(-1) > 0)


# --------------------------------------------------------------- the model

@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke(ARCH).replace(dtype="float32")
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_smoke(ARCH).replace(dtype="float32")
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), cfg))
    return jm, jp, tm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_of_every_leaf(dtype):
    """Each JAX leaf lands on the port's parameter of its name, shape and
    value, lead layers first; the router stays float32 in a bf16 model."""
    jcfg = jax_smoke(ARCH).replace(dtype=dtype)
    jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_smoke(ARCH).replace(dtype=dtype)
    sd = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    tm = build_model(cfg, device="cpu")
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    want = {"embed": jp["embed"], "final_norm": jp["final_norm"],
            "lm_head": jp["lm_head"]}
    for name, leaf in jax.tree_util.tree_flatten_with_path(
            jp["lead_blocks"][0])[0]:
        want["blocks.0." + ".".join(k.key for k in name)] = leaf
    for name, leaf in jax.tree_util.tree_flatten_with_path(jp["blocks"])[0]:
        for i in range(leaf.shape[0]):
            want[f"blocks.{1 + i}." + ".".join(k.key for k in name)] = \
                leaf[i]
    assert set(want) == set(sd)
    for name, leaf in want.items():
        t = tm.state_dict()[name]
        assert tuple(t.shape) == leaf.shape, name
        assert t.dtype == (torch.float32 if name.endswith("moe.router")
                           else getattr(torch, dtype)), name
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(leaf, np.float32))
    assert tm.blocks[0].moe is None and tm.blocks[0].ffn["w_up"].shape == (
        cfg.d_model, cfg.moe.d_ff_dense)
    assert all(b.ffn is None for b in tm.blocks[1:])


def test_forward_prefill_and_decode_step_match_jax(models):
    jm, jp, tm = models
    toks = np.random.default_rng(2).integers(0, 256, (2, 12)).astype(
        np.int32)
    jl, jaux = jm.forward(jp, jnp.asarray(toks))
    tl, aux = tm.forward(torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6,
                               rtol=1e-5)
    assert float(aux) > 0
    jlog, jcache = jm.prefill(jp, jnp.asarray(toks[:, :10]))
    tlog, cache = tm.prefill(torch.from_numpy(toks[:, :10]))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4,
                               rtol=1e-4)
    # the JAX cache keeps its lead layer apart; the port's is lead-first
    np.testing.assert_allclose(
        cache["k"].numpy(), np.concatenate(
            [np.asarray(jcache["lead_k"]), np.asarray(jcache["k"])]),
        atol=1e-5, rtol=1e-5)
    jcache = jm.extend_cache(jcache, 4)
    k_rows = torch.nn.functional.pad(cache["k"], (0, 0, 0, 0, 0, 4))
    v_rows = torch.nn.functional.pad(cache["v"], (0, 0, 0, 0, 0, 4))
    cache = tm.paged_cache_view(k_rows.transpose(0, 1),
                                v_rows.transpose(0, 1), [10, 10])
    for t in (10, 11):
        jlog, jcache = jm.decode_step(jp, jnp.asarray(toks[:, t]), jcache)
        tlog, cache = tm.decode_step(torch.from_numpy(toks[:, t]), cache)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=1e-4, rtol=1e-4)


def test_prefill_and_decode_match_forward_at_a_dropless_capacity(models):
    """As the reference's own test: at capacity factor 64 nothing drops,
    so the cached path gives the teacher-forced logits."""
    _, jp, _ = models
    cfg = get_smoke(ARCH).replace(dtype="float32")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=64.0))
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), cfg))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 12)).astype(np.int32))
    full, _ = tm.forward(toks)
    logits, cache = tm.prefill(toks[:, :10])
    torch.testing.assert_close(logits, full[:, 9], atol=1e-4, rtol=1e-4)
    pad = (0, 0, 0, 0, 0, 2)
    cache = tm.paged_cache_view(
        torch.nn.functional.pad(cache["k"], pad).transpose(0, 1),
        torch.nn.functional.pad(cache["v"], pad).transpose(0, 1), [10, 10])
    for t in (10, 11):
        logits, cache = tm.decode_step(toks[:, t], cache)
        torch.testing.assert_close(logits, full[:, t], atol=1e-4, rtol=1e-4)


# -------------------------------------------------------------- the engine

PREFIX = list(range(10, 50))                     # 40 tokens: 5 full pages
PROMPTS = [PREFIX + [100, 101, 102, 103, 104], PREFIX + [105, 106],
           list(range(60, 79)), PREFIX + [100, 101, 102, 103, 104]]
LONG, SHORT = list(range(120, 129)), [5, 6, 7, 8, 9]
STATS = ("prefix_hits", "tokens_reused", "pages_shared",
         "coalesced_requests", "prefill_tokens", "prefill_tokens_saved")


def _wait(cond, timeout=120.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.002)


def _scenario(eng):
    """A fresh batch (the second prompt shares the first's 40-token
    prefix, the fourth duplicates the first), the same batch warm (each
    prompt shares all but its last token), then a request admitted
    mid-decode."""
    out = {"fresh": eng.generate(PROMPTS, max_new_tokens=6)}
    out["warm"] = eng.generate(PROMPTS, max_new_tokens=6)
    out["stats"] = {k: getattr(eng.stats, k) for k in STATS}
    n0 = eng.stats.decode_tokens
    h1 = eng.submit(LONG, max_new_tokens=16)
    _wait(lambda: eng.stats.decode_tokens > n0)
    h2 = eng.submit(SHORT, max_new_tokens=4)
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


def _torch_engine(weights, **kw):
    eng = InferenceEngine(weights[1], seed=0, device="cpu", **kw)
    eng.load(weights[2])
    return eng


@pytest.mark.parametrize("paged", [True, False])
def test_greedy_tokens_equal_jax_path_for_path(weights, jax_run, paged):
    """Fresh, warm and mid-decode tokens and the sharing counters equal
    the JAX engine's (paged), on the paged path and on the dense view."""
    eng = _torch_engine(weights, paged_decode=paged)
    try:
        out = _scenario(eng)
        assert out == jax_run
        assert out["fresh"][0] == out["fresh"][3]            # duplicate
        assert out["stats"]["coalesced_requests"] >= 2
        assert out["stats"]["prefix_hits"] >= 4
        assert (eng.stats.view_rebuilds == 0) == paged
        assert eng.param_bytes() == sum(
            t.numel() * 4 for t in weights[2].values())
    finally:
        eng.shutdown()


def test_warm_and_cold_tokens_differ_as_the_jax_engine_s_do(weights,
                                                           jax_run):
    """The reference's capacity is ceil(Ng*K/E*cf) per group and a chunk
    prefill is one group of its padded length, so a prompt admitted over
    a shared prefix (a 16-slot suffix chunk, capacity 5) may route and
    drop otherwise than the same prompt cold (a 48-slot chunk, capacity
    15), and decode other tokens.  The port follows: its warm and cold
    tokens differ where, and as, the JAX engine's do."""
    eng = _torch_engine(weights)
    try:
        with _routing() as rec:
            cold = eng.generate(PROMPTS[:1], max_new_tokens=6)
            warm = eng.generate(PROMPTS[:1], max_new_tokens=6)
        assert eng.stats.prefix_hits == 1
    finally:
        eng.shutdown()
    assert cold[0] == jax_run["fresh"][0] and warm[0] == jax_run["warm"][0]
    assert cold[0] != warm[0]
    # the second prompt's fresh admission already shared the prefix
    assert [jax_run["fresh"][i] == jax_run["warm"][i] for i in range(4)] \
        == [False, True, True, False]
    cfg = get_smoke(ARCH)
    n_moe = cfg.num_layers - cfg.moe.first_dense_layers
    chunks = [(e["tokens"], e["capacity"]) for e in rec if e["tokens"] > 8]
    assert chunks == [(48, 15)] * n_moe + [(16, 5)] * n_moe


def test_prefix_from_the_jax_engine_lands_on_the_right_layers(weights,
                                                              jax_run):
    """KV exported by the JAX engine (lead layer first, f32 numpy) equals
    the port's own KV of the same prompt layer by layer, and once
    imported, the port serves the prompt over it with the JAX engine's
    warm tokens."""
    jeng = JaxEngine(jax_smoke(ARCH).replace(dtype="float32"), seed=0)
    jeng.params = weights[0].params
    try:
        jeng.generate(PROMPTS[:1], max_new_tokens=2)
        toks, k, v = jeng.export_prefix(PROMPTS[0])
    finally:
        jeng.shutdown()
    assert k.shape[0] == 3 and len(toks) == len(PROMPTS[0])
    own = _torch_engine(weights)
    try:
        own.generate(PROMPTS[:1], max_new_tokens=2)
        _, k_own, v_own = own.export_prefix(PROMPTS[0])
    finally:
        own.shutdown()
    np.testing.assert_allclose(k_own, k, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(v_own, v, atol=1e-5, rtol=1e-5)
    eng = _torch_engine(weights)
    try:
        assert eng.import_prefix(toks, k, v) > 0
        out = eng.generate(PROMPTS[:1], max_new_tokens=6)
        assert eng.stats.prefix_hits == 1
        assert out[0] == jax_run["warm"][0]
    finally:
        eng.shutdown()


def test_engine_raises_without_a_card_unless_the_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(get_smoke(ARCH))
    eng = InferenceEngine(get_smoke(ARCH), device="cpu")
    assert eng.model.blocks[1].moe.router.device.type == "meta"
    eng.load()
    assert eng.model.blocks[1].moe.router.dtype == torch.float32
    eng.unload()
    assert eng.model.blocks[1].moe.w_gate.device.type == "meta"
    eng.shutdown()
