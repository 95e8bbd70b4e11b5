"""Sliding-window attention in the port's ``TransformerLM`` against the JAX
package, on the CPU (mixtral-8x22b's smoke config: window 16, 4 experts
top-2, float32, the JAX init bridged).

``forward``, ``prefill`` and ``decode_step`` give JAX's logits, the MoE
layers its capacity and aux loss; the ring cache's hooks
(``cache_capacity``, ``extend_cache``, ``cache_batch_axes``,
``_kv_slot_positions``) act as JAX's, and no pages back the ring, so the
engine serves the model on dense rows and gives the JAX engine's greedy
tokens where the two packages place the ring alike (prompts of at most
the window, or a multiple of it).  Past the window the JAX ``prefill``
keeps the last T positions in slots 0..T-1 where its decode expects
position p in slot p % T; the port rolls them into place, so its cached
path equals its teacher-forced forward and JAX's does not (pinned).
qwen3's full-attention ``decode_step`` stays bitwise what it was.
"""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.engine.models import build_model as jax_build  # noqa: E402
from repro.engine.models import moe as jax_moe  # noqa: E402
from repro.training.optimizer import adamw_init  # noqa: E402
from repro_torch.bridge import opt_state_from_jax, params_from_jax  # noqa
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.engine.engine import InferenceEngine  # noqa: E402
from repro_torch.engine.models import build_model  # noqa: E402
from repro_torch.engine.models import moe  # noqa: E402

ARCH = "mixtral-8x22b"
WINDOW = 16
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU shapes gain nothing from torch's thread pool, and its
    spinning threads would slow the tests other workers run meanwhile."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(capacity_factor=None):
    """(JAX, port) float32 smoke configs, at ``capacity_factor`` if given
    (4 experts top-2: 2.0 and up drop nothing)."""
    out = []
    for get in (jax_smoke, get_smoke):
        cfg = get(ARCH).replace(dtype="float32")
        if capacity_factor:
            cfg = cfg.replace(moe=dataclasses.replace(
                cfg.moe, capacity_factor=capacity_factor))
        out.append(cfg)
    return out


def _pair(capacity_factor=None, seed=0):
    """The JAX model, its params and the port's model on them."""
    jcfg, cfg = _configs(capacity_factor)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), cfg))
    return jm, jp, tm


@pytest.fixture(scope="module")
def models():
    return _pair()


def _toks(S, B=2, seed=2):
    return np.random.default_rng(seed).integers(1, 256, (B, S)).astype(
        np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_smoke_config_is_jax_and_a_ring():
    jcfg, cfg = _configs()
    assert cfg.swa_window == jcfg.swa_window == WINDOW
    assert vars(cfg.moe) == vars(jcfg.moe)
    assert cfg.moe.num_shared_experts == 0 \
        and cfg.moe.first_dense_layers == 0
    assert cfg.attention_impl == "cuda"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [ARCH, "deepseek-67b"])
def test_bridge_round_trip_of_every_leaf(arch, dtype):
    """Each JAX leaf lands on the port's parameter of its name, shape and
    value (the MoE leaves without ``shared``, the router in float32), and
    the AdamW state's moments bridge onto the same names."""
    jp = jax_build(jax_smoke(arch).replace(dtype=dtype)).init(
        jax.random.PRNGKey(0))
    cfg = get_smoke(arch).replace(dtype=dtype)
    sd = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    tm = build_model(cfg, device="cpu")
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    want = {"embed": jp["embed"], "final_norm": jp["final_norm"],
            "lm_head": jp["lm_head"]}
    assert "lead_blocks" not in jp
    for name, leaf in jax.tree_util.tree_flatten_with_path(jp["blocks"])[0]:
        for i in range(leaf.shape[0]):
            want[f"blocks.{i}." + ".".join(k.key for k in name)] = leaf[i]
    assert set(want) == set(sd)
    assert not any(".shared." in n for n in sd)
    assert any(n.endswith("moe.w_gate") for n in sd) == (arch == ARCH)
    for name, leaf in want.items():
        t = tm.state_dict()[name]
        assert tuple(t.shape) == leaf.shape, name
        assert t.dtype == (torch.float32 if name.endswith("moe.router")
                           else getattr(torch, dtype)), name
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(leaf, np.float32))
    state = adamw_init(jp)
    state = {"m": jax.tree.map(lambda a: a + 1.5, state["m"]),
             "v": jax.tree.map(lambda a: a + 0.25, state["v"]),
             "step": state["step"] + 3}
    st = opt_state_from_jax(jax.tree.map(np.asarray, state), cfg)
    assert set(st["m"]) == set(st["v"]) == set(sd)
    assert all(bool((t == 1.5).all()) and t.dtype == torch.float32
               for t in st["m"].values())
    assert int(st["step"]) == 3


def test_forward_matches_jax_with_its_capacity_and_aux(models):
    """Logits within 1e-4 and the aux loss within 1e-6 of JAX's; every
    MoE call's capacity is the reference's, ``max(ceil(Ng*K/E*cf), K)``
    over one group a sequence, and at this length some slots drop."""
    jm, jp, tm = models
    toks = _toks(24)
    caps, rec, inner, jinner = [], [], moe._dispatch_indices, \
        jax_moe._dispatch_indices

    def spy(top_idx, num_experts, capacity):
        pos, keep = inner(top_idx, num_experts, capacity)
        rec.append((tuple(top_idx.shape), capacity, int((~keep).sum())))
        return pos, keep

    def jspy(top_idx, num_experts, capacity):
        caps.append(capacity)
        return jinner(top_idx, num_experts, capacity)

    moe._dispatch_indices, jax_moe._dispatch_indices = spy, jspy
    try:
        jl, jaux = jm.forward(jp, jnp.asarray(toks))
        tl, aux = tm.forward(torch.from_numpy(toks))
    finally:
        moe._dispatch_indices, jax_moe._dispatch_indices = inner, jinner
    _close(tl, jl)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6,
                               rtol=1e-5)
    m = tm.cfg.moe
    want = max(int(np.ceil(24 * m.top_k / m.num_experts
                           * m.capacity_factor)), m.top_k)
    assert [r[:2] for r in rec] == [((2, 24, 2), want)] * tm.cfg.num_layers
    assert caps and set(caps) == {want}    # JAX traces its scanned layer once
    assert sum(r[2] for r in rec) > 0


@pytest.mark.parametrize("S", [10, WINDOW, 2 * WINDOW])
def test_prefill_and_decode_step_match_jax(models, S):
    """Prompts of at most the window, or a multiple of it, where both
    packages place the ring alike: the cache equals JAX's slot for slot
    and 12 decode steps, wrapping the ring, give JAX's logits."""
    jm, jp, tm = models
    n_dec = 12
    toks = _toks(S + n_dec, seed=S)
    jlog, jc = jm.prefill(jp, jnp.asarray(toks[:, :S]))
    tlog, tc = tm.prefill(torch.from_numpy(toks[:, :S]))
    _close(tlog, jlog)
    T = min(S, WINDOW)
    assert tuple(tc["k"].shape) == (tm.cfg.num_layers, 2, T, 2, 16)
    _close(tc["k"], jc["k"], 1e-5)
    _close(tc["v"], jc["v"], 1e-5)
    jc = jm.extend_cache(jc, n_dec)
    tc = tm.extend_cache(tc, n_dec)
    assert tc["k"].shape[2] == jc["k"].shape[2] == WINDOW
    for t in range(S, S + n_dec):
        jlog, jc = jm.decode_step(jp, jnp.asarray(toks[:, t]), jc)
        tlog, tc = tm.decode_step(torch.from_numpy(toks[:, t]), tc)
        _close(tlog, jlog)
    _close(tc["k"], jc["k"], 1e-5)
    assert tc["length"].tolist() == [S + n_dec] * 2


@pytest.fixture(scope="module")
def dropless():
    """The pair at capacity factor 2.0: nothing drops, so the cached path
    and the teacher-forced forward route alike."""
    return _pair(capacity_factor=2.0, seed=1)


@pytest.mark.parametrize("S", [20, 35])
def test_jax_ring_misplaced_past_the_window_port_rolls(dropless, S):
    """Prefill S > window with S % window != 0, then decode: the port's
    logits follow its forward at every position; JAX's cache holds the
    same rows rolled back by S % T, and its logits leave its forward by
    far more than rounding."""
    jm, jp, tm = dropless
    n_dec = 5
    toks = _toks(S + n_dec, B=1, seed=S)
    full, _ = tm(torch.from_numpy(toks))
    jfull, _ = jm.forward(jp, jnp.asarray(toks))
    _close(full, jfull)
    logits, cache = tm.prefill(torch.from_numpy(toks[:, :S]))
    jlog, jc = jm.prefill(jp, jnp.asarray(toks[:, :S]))
    assert cache["k"].shape[2] == WINDOW
    np.testing.assert_allclose(
        np.roll(cache["k"].numpy(), -(S % WINDOW), axis=2),
        np.asarray(jc["k"]), atol=1e-5, rtol=1e-5)
    _close(logits, full[:, S - 1])
    _close(jlog, jfull[:, S - 1])          # the prefill's own logits agree
    jax_gap = 0.0
    for i in range(n_dec):
        logits, cache = tm.decode_step(torch.from_numpy(toks[:, S + i]),
                                       cache)
        _close(logits, full[:, S + i])
        jlog, jc = jm.decode_step(jp, jnp.asarray(toks[:, S + i]), jc)
        jax_gap = max(jax_gap, float(np.abs(
            np.asarray(jlog) - np.asarray(jfull[:, S + i])).max()))
    scale = float(np.abs(np.asarray(jfull[:, S:])).max())
    assert jax_gap > 1e-2 * scale, (jax_gap, scale)
    assert int(cache["length"][0]) == S + n_dec


def test_ring_hooks_as_jax(models):
    """No pages back the ring, no chunked prefill runs on it; capacity,
    batch axes, growth up to the window and the slots' positions equal
    the JAX hooks'."""
    jm, jp, tm = models
    assert tm.paged_kv_layout() is None and jm.paged_kv_layout() is None
    toks = torch.from_numpy(_toks(6))
    _, cache = tm.prefill(toks)
    with pytest.raises(ValueError):
        tm.prefill_with_cache(toks[:, :2], cache)
    for n in (1, 10, WINDOW, 100):
        assert tm.cache_capacity(n) == jm.cache_capacity(n)
    assert tm.cache_batch_axes(cache) == jm.cache_batch_axes(cache)
    assert tm.extend_cache(cache, 4)["k"].shape[2] == 10
    grown = tm.extend_cache(cache, 500)
    assert grown["k"].shape[2] == WINDOW
    assert torch.equal(grown["k"][:, :, :6], cache["k"])
    assert not grown["k"][:, :, 6:].any()
    assert tm.extend_cache(grown, 8) is grown
    pos = np.asarray([0, 5, 15, 16, 17, 40, 47], np.int32)
    np.testing.assert_array_equal(
        tm._kv_slot_positions(torch.from_numpy(pos), WINDOW).numpy(),
        np.asarray(jm._kv_slot_positions(jnp.asarray(pos), WINDOW)))


# -------------------------------------------------------------- the engine

PROMPTS = [list(range(10, 20)), list(range(30, 46)),
           list(range(50, 82)), list(range(90, 95)),
           list(range(10, 20))]                    # the last a duplicate
LONG, SHORT = list(range(120, 136)), [5, 6, 7, 8]


def _wait(cond, timeout=120.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.002)


def _scenario(eng):
    """Prompts of 10, 16, 32 and 5 tokens and a duplicate, 14 new tokens
    each (every ring wraps), then a request admitted mid-decode."""
    out = {"batch": eng.generate(PROMPTS, max_new_tokens=14)}
    n0 = eng.stats.decode_tokens
    h1 = eng.submit(LONG, max_new_tokens=20)
    _wait(lambda: eng.stats.decode_tokens > n0)
    h2 = eng.submit(SHORT, max_new_tokens=6)
    out["mid"] = (h1.result(), h2.result())
    out["coalesced"] = eng.stats.coalesced_requests
    return out


@pytest.fixture(scope="module")
def engine_weights():
    jcfg, cfg = _configs()
    eng = JaxEngine(jcfg, seed=0)
    eng.load()
    return eng, cfg, params_from_jax(jax.tree.map(np.asarray, eng.params),
                                     cfg)


def test_greedy_tokens_equal_jax_on_dense_rows(engine_weights):
    jeng, cfg, sd = engine_weights
    try:
        want = _scenario(jeng)
    finally:
        jeng.shutdown()
    eng = InferenceEngine(cfg, seed=0, device="cpu")
    eng.load(sd)
    try:
        out = _scenario(eng)
        assert out == want
        assert out["batch"][0] == out["batch"][4] and out["coalesced"] >= 1
        assert eng.kv is None and eng.stats.view_rebuilds > 0
        assert eng.stats.prefix_hits == 0
    finally:
        eng.shutdown()


# ------------------------------------------- full attention stays as it was

def _decode_step_before_the_ring(model, token, cache):
    """``TransformerLM.decode_step`` as it was before sliding-window rings:
    slot ``length % T``, ``kv_pos`` from ``t_idx <= pos``."""
    from repro_torch.engine.models import layers as L
    cfg = model.cfg
    B, T = token.shape[0], cache["k"].shape[2]
    pos = cache["length"].to(torch.int32)
    slot = torch.remainder(pos, T).long()
    t_idx = torch.arange(T, dtype=torch.int32)[None]
    kv_pos = torch.where(t_idx <= pos[:, None], t_idx, -1).to(
        torch.int32).contiguous()
    batch_ix = torch.arange(B)
    x = model.embed[token][:, None, :]
    for i, blk in enumerate(model.blocks):
        q, k, v = model._qkv(blk, x, pos[:, None])
        cache["k"][i][batch_ix, slot] = k[:, 0]
        cache["v"][i][batch_ix, slot] = v[:, 0]
        o = L.attention(q, cache["k"][i], cache["v"][i],
                        q_positions=pos[:, None], kv_positions=kv_pos,
                        causal=True, window=cfg.swa_window,
                        impl=cfg.attention_impl)
        x, _ = model._finish_block(blk, x, o)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return x[:, -1] @ model._head()


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-67b"])
@torch.no_grad()
def test_full_attention_decode_step_is_bitwise_unchanged(arch):
    cfg = get_smoke(arch).replace(dtype="float32")
    tm = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(3))
    assert not cfg.swa_window and tm.paged_kv_layout() is not None
    toks = torch.from_numpy(_toks(9, B=3))
    _, cache = tm.prefill(toks)
    pad = (0, 0, 0, 0, 0, 7)
    cache = {"k": torch.nn.functional.pad(cache["k"], pad),
             "v": torch.nn.functional.pad(cache["v"], pad),
             "length": torch.tensor([9, 4, 7], dtype=torch.int32)}
    # one kv_pos for both caches: the ring's positions are the old
    # ``t_idx <= pos`` form at every length a full cache holds (and -1)
    from repro_torch.engine.models import layers as L
    T = cache["k"].shape[2]
    pos = torch.arange(-1, T, dtype=torch.int32)
    t_idx = torch.arange(T, dtype=torch.int32)[None]
    assert torch.equal(L.ring_slot_positions(pos, T),
                       torch.where(t_idx <= pos[:, None], t_idx, -1).to(
                           torch.int32))
    ref = {k: v.clone() for k, v in cache.items()}
    for t in (11, 12, 13):
        tok = torch.tensor([t, t + 1, t + 2])
        want = _decode_step_before_the_ring(tm, tok, ref)
        ref["length"] = ref["length"] + 1
        got, cache = tm.decode_step(tok, cache)
        assert torch.equal(got, want)
        assert torch.equal(cache["k"], ref["k"]) \
            and torch.equal(cache["v"], ref["v"])
