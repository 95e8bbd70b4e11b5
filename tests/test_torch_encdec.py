"""The port's encoder-decoder (whisper-tiny) and its layers against the JAX
package's, and the attention dispatcher's one-token non-causal query.

* Layers: ``layer_norm``, ``sinusoidal_positions`` and
  ``ffn_apply_nogate`` equal JAX's (1e-5); GELU is the tanh approximation
  of ``jax.nn.gelu``, not PyTorch's default erf form.
* The dispatcher: whisper's decode cross-attention is a one-token query
  with ``causal=False``.  The decode kernel masks keys past the query
  position, so ``attention`` hands it each row's last valid key position;
  under both impls the query sees every valid key, as ``attention_xla``
  does.  The JAX ``"pallas"`` path drops ``causal`` there and hides the
  keys past the query position; the port follows ``"xla"``.
* The model: ``get_smoke("whisper-tiny")`` in float32 (2 encoder and 2
  decoder layers, d_model 64, 4 heads of 16) made by the JAX init and
  bridged; forward, prefill (with its caches) and decode steps equal
  JAX's ``"xla"`` path to 1e-4 with 8 and 5 frames, under both of the
  port's impls (``"cuda"`` runs the kernels' plain versions on CPU
  tensors), with decode positions before and past the last frame.
* The engine: requests with different frame counts share one dense-row
  batch (cross KV padded to ``enc_max_len``) and give the JAX engine's
  greedy tokens.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.engine.models import build_model as jax_build  # noqa: E402
from repro.engine.models import layers as JL  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.engine.engine import InferenceEngine  # noqa: E402
from repro_torch.engine.models import build_model  # noqa: E402
from repro_torch.engine.models import layers as L  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref)

ARCH = "whisper-tiny"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU shapes gain nothing from torch's thread pool, and its
    spinning threads would slow the tests other workers run meanwhile."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(t, j, tol):
    a = t.float().numpy()
    b = np.asarray(j, np.float32)
    np.testing.assert_allclose(a, b, atol=tol * max(1.0, np.abs(b).max()),
                               rtol=tol)


# ----------------------------------------------------------------- layers

def test_layer_norm_and_sinusoidal_positions_equal_jax():
    rng = np.random.default_rng(0)
    x = (3 * rng.normal(size=(2, 5, 48)) + 1.5).astype(np.float32)
    w, b = (rng.normal(size=(48,)).astype(np.float32) for _ in range(2))
    _close(L.layer_norm(_t(x), _t(w), _t(b)),
           JL.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)),
           1e-5)
    for length, dim in ((7, 64), (64, 64)):
        _close(L.sinusoidal_positions(length, dim),
               JL.sinusoidal_positions(length, dim), 1e-5)
    # whisper's 1500 frames: f32 sin and cos of angles up to 1499 rad,
    # whose range reductions differ between the two libraries by ~1e-4
    _close(L.sinusoidal_positions(1500, 384),
           JL.sinusoidal_positions(1500, 384), 5e-4)


def test_ffn_apply_nogate_equals_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 32)).astype(np.float32)
    p = {"w_up": (rng.normal(size=(32, 80)) / 4).astype(np.float32),
         "w_down": (rng.normal(size=(80, 32)) / 8).astype(np.float32)}
    _close(L.ffn_apply_nogate({k: _t(v) for k, v in p.items()}, _t(x)),
           JL.ffn_apply_nogate({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x)), 1e-5)


def test_gelu_is_the_tanh_approximation_not_the_erf_form():
    x = np.linspace(-6, 6, 2001).astype(np.float32)
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    np.testing.assert_allclose(L.gelu(_t(x)).numpy(), ref, atol=1e-6,
                               rtol=1e-6)
    assert np.abs(F.gelu(_t(x)).numpy() - ref).max() > 1e-4


# ------------------------------------------------------------- dispatcher

def _cross_inputs(seed, B=3, T=40, H=4, Hkv=2, Dh=16):
    """One-token queries over T frame slots; row 0 all valid, row 1 its
    first 23, row 2 none (a padded decode row)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, T, Hkv, Dh)).astype(np.float32)
    v = rng.normal(size=(B, T, Hkv, Dh)).astype(np.float32)
    n_valid = np.asarray([T, 23, 0])
    frames = np.arange(T)[None]
    kvp = np.where(frames < n_valid[:, None], frames, -1).astype(np.int32)
    return q, k, v, kvp


@pytest.mark.parametrize("qpos", [0, 5, 100])
def test_one_token_non_causal_query_sees_every_valid_key(qpos):
    """Under ``"torch"`` and ``"cuda"`` a non-causal one-token query is the
    decode function at each row's last valid key position, whatever its
    own position; a row without a valid key gives 0 under ``"cuda"``."""
    q, k, v, kvp = _cross_inputs(0)
    qp = np.full((3, 1), qpos, np.int32)
    args = dict(q_positions=torch.from_numpy(qp),
                kv_positions=torch.from_numpy(kvp), causal=False)
    plain = L.attention(_t(q), _t(k), _t(v), impl="torch", **args)
    kernel = L.attention(_t(q), _t(k), _t(v), impl="cuda", **args)
    repaired = torch.from_numpy(kvp.max(axis=1).astype(np.int32))
    ref = decode_attention_ref(_t(q)[:, 0], _t(k), _t(v),
                               q_positions=repaired,
                               kv_positions=torch.from_numpy(kvp))
    torch.testing.assert_close(plain[:2, 0], ref[:2], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(kernel[:, 0], ref, atol=1e-6, rtol=1e-6)
    assert torch.all(kernel[2] == 0)
    with pytest.raises(AssertionError, match="window"):
        L.attention(_t(q), _t(k), _t(v), impl="cuda", window=8, **args)


@pytest.mark.parametrize("qpos,differ", [(5, True), (22, True), (39, False)])
def test_jax_pallas_and_xla_disagree_below_the_last_key_port_follows_xla(
        qpos, differ):
    """The reference's fault, pinned: under ``"pallas_interpret"`` the JAX
    dispatcher sends a one-token query to the decode kernel without
    ``causal`` (``layers.py:319-323``), which masks ``kp <= qp``
    (``decode_attention/kernel.py:48``); ``"xla"`` honours
    ``causal=False``.  They differ once the query position is below a
    row's last valid key (row 0: 39, row 1: 22) and agree past it; the
    port equals ``"xla"`` either way."""
    q, k, v, kvp = _cross_inputs(1)
    kvp = kvp[:2].copy()
    q, k, v = q[:2], k[:2], v[:2]
    qp = np.full((2, 1), qpos, np.int32)
    jargs = dict(q_positions=jnp.asarray(qp), kv_positions=jnp.asarray(kvp),
                 causal=False)
    xla = np.asarray(JL.attention(*map(jnp.asarray, (q, k, v)), impl="xla",
                                  **jargs))
    pallas = np.asarray(JL.attention(*map(jnp.asarray, (q, k, v)),
                                     impl="pallas_interpret", **jargs))
    gap = np.abs(xla - pallas).max()
    assert (gap > 1e-2) if differ else (gap < 1e-5), gap
    targs = dict(q_positions=torch.from_numpy(qp),
                 kv_positions=torch.from_numpy(kvp), causal=False)
    for impl in ("torch", "cuda"):
        _close(L.attention(_t(q), _t(k), _t(v), impl=impl, **targs), xla,
               1e-5)


# ------------------------------------------------------------------ model

@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke(ARCH).replace(dtype="float32", param_dtype="float32")
    cfg = get_smoke(ARCH).replace(dtype="float32", param_dtype="float32")
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), cfg))
    return jm, jp, tm


def _frames(seed, B, T, d=64):
    return np.random.default_rng(seed).normal(size=(B, T, d)).astype(
        np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_of_every_leaf(dtype):
    """Every JAX leaf lands in the port at its shape, in the model dtype,
    with its values, and the port has no other parameter (the head is the
    embedding: whisper ties)."""
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
        if keys[0] in ("enc_blocks", "dec_blocks"):
            for i in range(leaf.shape[0]):
                expect[".".join([keys[0], str(i), *keys[1:]])] = leaf[i]
        else:
            expect[".".join(keys)] = leaf
    assert set(expect) == set(mine) == set(sd)
    assert "dec_blocks.1.xattn.wk" in mine and "enc_ln.b" in mine
    for name, leaf in expect.items():
        t = mine[name]
        assert tuple(t.shape) == leaf.shape, name
        assert t.dtype == getattr(torch, dtype), name
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(leaf, np.float32))


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("T_enc", [8, 5])
def test_forward_prefill_and_decode_step_match_jax(models, impl, T_enc):
    """Decode runs at positions 6-9: before the last of 8 frames, where
    the reference's ``"pallas"`` path would hide frames, and past it."""
    jm, jp, tm = models
    B, S = 2, 6
    toks = np.random.default_rng(T_enc).integers(0, 256, (B, S)).astype(
        np.int32)
    fr = _frames(T_enc, B, T_enc)
    jf, _ = jm.forward(jp, jnp.asarray(toks), jnp.asarray(fr))
    tf, aux = tm(torch.from_numpy(toks), _t(fr), impl=impl)
    _close(tf, jf, 1e-4)
    assert float(aux) == 0.0
    jl, jc = jm.prefill(jp, jnp.asarray(toks), jnp.asarray(fr), impl="xla")
    tl, tc = tm.prefill(torch.from_numpy(toks), _t(fr), impl=impl)
    _close(tl, jl, 1e-4)
    assert sorted(tc) == sorted(jc)
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape, key
        _close(tc[key], jc[key], 1e-4)
    jc, tc = jm.extend_cache(jc, 6), tm.extend_cache(tc, 6)
    assert tuple(tc["xk"].shape) == jc["xk"].shape \
        == (2, B, 64, 4, 16)                       # padded to enc_max_len
    step = jax.jit(jm.decode_step, static_argnames="impl")
    for i in range(4):
        tok = np.asarray([(5 * i + 11) % 256, (3 * i + 2) % 256], np.int32)
        jl, jc = step(jp, jnp.asarray(tok), jc, impl="xla")
        tl, tc = tm.decode_step(torch.from_numpy(tok), tc, impl=impl)
        _close(tl, jl, 1e-4)
    for key in jc:
        _close(tc[key], jc[key], 1e-4)
    assert tm.cache_batch_axes(tc) == {"k": 1, "v": 1, "xk": 1, "xv": 1,
                                       "enc_len": 0, "length": 0}
    assert tm.paged_kv_layout() is None
    zero = tm.init_cache(B, 16)
    assert {k: tuple(v.shape) for k, v in zero.items()} \
        == {k: v.shape for k, v in jm.init_cache(B, 16).items()}


def test_prefill_decode_matches_forward(models):
    """The port's copy of ``test_prefill_decode_matches_forward`` for
    whisper: the teacher-forced forward's logits equal prefill +
    decode_step's."""
    _, _, tm = models
    B, S = 2, 12
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (B, S)).astype(np.int64))
    frames = torch.ones(B, 8, 64)
    full, _ = tm(toks, frames)
    logits, cache = tm.prefill(toks[:, :S - 2], frames)
    cache = tm.extend_cache(cache, 4)
    torch.testing.assert_close(logits, full[:, S - 3], atol=2e-3, rtol=2e-3)
    for t in range(S - 2, S):
        logits, cache = tm.decode_step(toks[:, t], cache)
        torch.testing.assert_close(logits, full[:, t], atol=2e-3, rtol=2e-3)


def test_recurrent_state_snapshot_sharing_close(models):
    """The port's copy of ``test_recurrent_state_snapshot_sharing_close``
    for whisper: a 10-token prefill's caches, stepped over 4 more tokens,
    give the 14-token prefill's logits over the same frames."""
    _, _, tm = models
    toks = torch.arange(10, 24)[None]
    frames = _t(_frames(4, 1, 6))
    full, _ = tm.prefill(toks, frames)
    lg, cache = tm.prefill(toks[:, :10], frames)
    cache = tm.extend_cache(cache, 8)
    for t in range(10, 14):
        lg, cache = tm.decode_step(toks[:, t], cache)
    torch.testing.assert_close(lg, full, atol=1e-4, rtol=1e-4)


# ----------------------------------------------------------------- engine

PROMPTS = [[1, 2, 3, 4], list(range(10, 20)), [5, 6], list(range(30, 37))]
FRAMES = (64, 40, 17, 3)


@pytest.fixture(scope="module")
def jax_run():
    eng = JaxEngine(jax_smoke(ARCH).replace(dtype="float32"), seed=0,
                    max_seq_len=64)
    eng.load()
    cfg = get_smoke(ARCH).replace(dtype="float32")
    sd = params_from_jax(jax.tree.map(np.asarray, eng.params), cfg)
    extras = [{"frames": _frames(10 + i, 1, n)} for i, n in enumerate(FRAMES)]
    try:
        outs = eng.generate(PROMPTS, max_new_tokens=6, extras=extras)
    finally:
        eng.shutdown()
    return cfg, sd, extras, outs


@pytest.mark.parametrize("as_tensor", [False, True])
def test_mixed_frame_counts_share_a_batch_and_give_the_jax_tokens(jax_run,
                                                                  as_tensor):
    """Four requests with 64, 40, 17 and 3 frames decode in one dense-row
    batch (numpy or tensor frames alike): the JAX engine's greedy tokens,
    and each request's tokens alone."""
    cfg, sd, extras, j_outs = jax_run
    if as_tensor:
        extras = [{"frames": _t(e["frames"])} for e in extras]
    eng = InferenceEngine(cfg, seed=0, max_seq_len=64, device="cpu")
    eng.load(sd)
    try:
        outs = eng.generate(PROMPTS, max_new_tokens=6, extras=extras)
        assert eng.kv is None and eng.stats.peak_batch == 4
        assert eng.stats.prefill_tokens == sum(map(len, PROMPTS))
        alone = eng.generate([PROMPTS[3]], max_new_tokens=6,
                             extras=[extras[3]])[0]
        with pytest.raises(ValueError, match="frames"):
            eng.generate([PROMPTS[0]], max_new_tokens=2)
    finally:
        eng.shutdown()
    assert outs == j_outs
    assert alone == outs[3]

