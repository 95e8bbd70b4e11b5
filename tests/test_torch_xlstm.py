"""The port's xLSTM (xlstm-350m, the ssm family) against the JAX package's.

``get_smoke("xlstm-350m")`` in float32 (one mLSTM/sLSTM pair, d_model 64,
2 heads of 32) is made by the JAX init and bridged into the port.  The
cells (``mlstm_step``, ``slstm_step``) equal JAX's to 1e-5 on inputs drawn
from numpy seeds, their sequence forms equal the step loop, the model's
forward, prefill (with its state) and decode steps equal JAX's to 1e-4,
and ``InferenceEngine``'s greedy tokens equal the JAX engine's on the
dense-row path.  The recurrences run in f32 in both packages, with sums
in other orders: the tolerances cover that rounding and nothing more.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.engine.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro.engine.models import build_model as jax_build  # noqa: E402
from repro.engine.models import xlstm as jxl  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.engine.engine import InferenceEngine  # noqa: E402
from repro_torch.engine.models import build_model, xlstm  # noqa: E402

ARCH = "xlstm-350m"


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


# ------------------------------------------------------------------ cells

def _mlstm_inputs(seed, B=3, H=2, Dh=16):
    rng = np.random.default_rng(seed)
    state = (rng.normal(size=(B, H, Dh, Dh)), rng.normal(size=(B, H, Dh)),
             rng.normal(size=(B, H)))
    xs = (rng.normal(size=(B, H, Dh)), rng.normal(size=(B, H, Dh)),
          rng.normal(size=(B, H, Dh)), 2 * rng.normal(size=(B, H)),
          2 * rng.normal(size=(B, H)))
    return [np.asarray(a, np.float32) for a in (*state, *xs)]


@pytest.mark.parametrize("seed", [0, 1])
def test_mlstm_step_equals_jax(seed):
    C, n, m, q, k, v, i, f = _mlstm_inputs(seed)
    (jC, jn, jm), jh = jxl.mlstm_step(
        tuple(map(jnp.asarray, (C, n, m))), *map(jnp.asarray, (q, k, v, i, f)))
    (tC, tn, tm), th = xlstm.mlstm_step(tuple(map(_t, (C, n, m))),
                                        *map(_t, (q, k, v, i, f)))
    for t, j in ((tC, jC), (tn, jn), (tm, jm), (th, jh)):
        _close(t, j, 1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_slstm_step_equals_jax(seed):
    rng = np.random.default_rng(seed)
    B, H, Dh = 3, 2, 8
    D = H * Dh
    state = [np.asarray(rng.normal(size=(B, D)), np.float32)
             for _ in range(4)]
    state[1] = np.abs(state[1]) + 0.5                    # n > 0
    x_gates = np.asarray(2 * rng.normal(size=(B, 4 * D)), np.float32)
    r_w = np.asarray(rng.normal(size=(4, H, Dh, Dh)) / Dh ** 0.5, np.float32)
    js, jh = jxl.slstm_step(tuple(map(jnp.asarray, state)),
                            jnp.asarray(x_gates), jnp.asarray(r_w))
    ts, th = xlstm.slstm_step(tuple(map(_t, state)), _t(x_gates), _t(r_w))
    for t, j in zip((*ts, th), (*js, jh)):
        _close(t, j, 1e-5)


def test_sequences_equal_their_step_loops():
    """The sequence forms (inputs cast and gates taken once, outputs
    preallocated) give the step function's states and outputs."""
    rng = np.random.default_rng(3)
    B, S, H, Dh = 2, 5, 2, 8
    q, k, v = (_t(rng.normal(size=(B, S, H, Dh))) for _ in range(3))
    i, f = (_t(rng.normal(size=(B, S, H))) for _ in range(2))
    zero = (torch.zeros(B, H, Dh, Dh), torch.zeros(B, H, Dh),
            torch.zeros(B, H))
    st, hs = xlstm.mlstm_sequence(q, k, v, i, f, zero)
    ref = zero
    for t in range(S):
        ref, h = xlstm.mlstm_step(ref, q[:, t], k[:, t], v[:, t], i[:, t],
                                  f[:, t])
        torch.testing.assert_close(hs[:, t], h, atol=1e-6, rtol=1e-6)
    for a, b in zip(st, ref):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    D = H * Dh
    xg = _t(rng.normal(size=(B, S, 4 * D)))
    r_w = _t(rng.normal(size=(4, H, Dh, Dh)) / Dh ** 0.5)
    zero = tuple(torch.zeros(B, D) for _ in range(4))
    st, hs = xlstm.slstm_sequence(xg, r_w, zero)
    ref = zero
    for t in range(S):
        ref, h = xlstm.slstm_step(ref, xg[:, t], r_w)
        torch.testing.assert_close(hs[:, t], h, atol=1e-6, rtol=1e-6)
    for a, b in zip(st, ref):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_of_every_leaf(dtype):
    """Every JAX leaf lands in the port at its shape, in the model dtype,
    with its values (bf16 -> f32 -> bf16 is exact), and the port has no
    other parameter."""
    jcfg = jax_smoke(ARCH).replace(dtype=dtype)
    cfg = get_smoke(ARCH).replace(dtype=dtype)
    jp = jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.PRNGKey(2)))
    tm = build_model(cfg, device="cpu")
    sd = params_from_jax(jp, cfg)
    tm.load_state_dict(sd)
    mine = dict(tm.named_parameters())
    assert set(mine) == set(sd)
    n_pairs = cfg.num_layers // 2
    expect = {"embed": jp["embed"], "final_norm": jp["final_norm"]}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp["pairs"])[0]:
        name = ".".join(p.key for p in path)
        for i in range(n_pairs):
            expect[f"pairs.{i}.{name}"] = leaf[i]
    assert set(expect) == set(mine)
    for name, leaf in expect.items():
        t = mine[name]
        assert tuple(t.shape) == leaf.shape, name
        assert t.dtype == getattr(torch, dtype), name
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(leaf, np.float32))


@pytest.mark.parametrize("S", [1, 3, 12])
def test_forward_prefill_and_decode_step_match_jax(models, S):
    """Logits and every state leaf equal JAX's (1e-4), prompts shorter and
    longer than the conv's window; decode_step leaves the caller's dict as
    it was."""
    jm, jp, tm = models
    toks = np.random.default_rng(S).integers(0, 256, (2, S)).astype(np.int32)
    jf, _ = jm.forward(jp, jnp.asarray(toks))
    tf, aux = tm(torch.from_numpy(toks))
    _close(tf, jf, 1e-4)
    assert float(aux) == 0.0
    jl, jc = jm.prefill(jp, jnp.asarray(toks))
    tl, tc = tm.prefill(torch.from_numpy(toks))
    _close(tl, jl, 1e-4)
    assert sorted(tc) == sorted(jc)
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape, key
        _close(tc[key], jc[key], 1e-4)
    assert tm.extend_cache(tc, 9) is tc and tm.paged_kv_layout() is None
    zero = tm.init_cache(2)
    assert {k: tuple(v.shape) for k, v in zero.items()} \
        == {k: v.shape for k, v in jm.init_cache(2).items()}
    assert tm.cache_batch_axes(zero) == {k: int(k != "length") for k in zero}
    step = jax.jit(jm.decode_step)
    for i in range(3):
        tok = np.asarray([(7 * i + 5) % 256, (3 * i + 1) % 256], np.int32)
        keys = list(tc)
        jl, jc = step(jp, jnp.asarray(tok), jc)
        old = tc
        tl, tc = tm.decode_step(torch.from_numpy(tok), tc)
        assert list(old) == keys and tc is not old
        assert int(old["length"][0]) == S + i
        _close(tl, jl, 1e-4)
    for key in jc:
        _close(tc[key], jc[key], 1e-4)


def test_prefill_decode_matches_forward(models):
    """The port's copy of ``test_prefill_decode_matches_forward``: the
    teacher-forced forward's logits equal prefill + decode_step's."""
    _, _, tm = models
    B, S = 2, 12
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (B, S)).astype(np.int64))
    full, _ = tm(toks)
    logits, cache = tm.prefill(toks[:, :S - 2])
    cache = tm.extend_cache(cache, 4)
    torch.testing.assert_close(logits, full[:, S - 3], atol=2e-3, rtol=2e-3)
    for t in range(S - 2, S):
        logits, cache = tm.decode_step(toks[:, t], cache)
        torch.testing.assert_close(logits, full[:, t], atol=2e-3, rtol=2e-3)


def test_recurrent_state_snapshot_sharing_close(models):
    """The port's copy of ``test_recurrent_state_snapshot_sharing_close``:
    a 10-token prefill's state, stepped over 4 more tokens, gives the
    14-token prefill's logits."""
    _, _, tm = models
    toks = torch.arange(10, 24)[None]
    full, _ = tm.prefill(toks)
    lg, cache = tm.prefill(toks[:, :10])
    cache = tm.extend_cache(cache, 8)
    for t in range(10, 14):
        lg, cache = tm.decode_step(toks[:, t], cache)
    torch.testing.assert_close(lg, full, atol=1e-4, rtol=1e-4)


# ----------------------------------------------------------------- engine

PROMPTS = [list(range(5, 13)), list(range(30, 41)), [2, 3, 4]]


@pytest.fixture(scope="module")
def jax_run():
    eng = JaxEngine(jax_smoke(ARCH).replace(dtype="float32"), seed=0,
                    max_seq_len=64)
    eng.load()
    cfg = get_smoke(ARCH).replace(dtype="float32")
    sd = params_from_jax(jax.tree.map(np.asarray, eng.params), cfg)
    try:
        outs = eng.generate(PROMPTS, max_new_tokens=3)
        alone = [eng.generate([p], max_new_tokens=3)[0] for p in PROMPTS]
    finally:
        eng.shutdown()
    return cfg, sd, outs, alone


def test_dense_row_families_mixed_lengths(jax_run):
    """The port's copy of ``test_dense_row_families_mixed_lengths`` for
    xlstm: variable-length prompts share the dense-row batch (no pages),
    each request's tokens equal its run alone, and both equal the JAX
    engine's."""
    cfg, sd, j_outs, j_alone = jax_run
    eng = InferenceEngine(cfg, seed=0, max_seq_len=64, device="cpu")
    eng.load(sd)
    try:
        outs = eng.generate(PROMPTS, max_new_tokens=3)
        assert eng.kv is None                     # no pages for state rows
        assert eng.stats.peak_batch == 3 and eng.stats.view_rebuilds >= 1
        alone = [eng.generate([p], max_new_tokens=3)[0] for p in PROMPTS]
    finally:
        eng.shutdown()
    assert outs == alone == j_outs == j_alone

