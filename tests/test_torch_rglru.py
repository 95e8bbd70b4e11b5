"""The port's GriffinLM (recurrentgemma) against the JAX package's.

``get_smoke("recurrentgemma-2b")`` deepened to 5 layers (one
(rglru, rglru, attn) group and two leftover recurrent blocks, as the full
model ends) is made by the JAX init and bridged into the port, once in
float32 (the algorithm) and once in bfloat16 (the working type).  Each
case runs the teacher-forced forward, the prefill and its state, and
decode steps on both models: the port under ``torch`` against JAX
``xla`` and under ``cuda`` (the plain kernel versions, on CPU tensors)
against JAX ``pallas_interpret``.  Prompts are as long as the window or a
multiple of it, where the reference places its ring correctly; past the
window the port is held against its own forward.

Tolerances: float32 1e-4 on logits and state (5 blocks of f32 matmuls and
two recurrences summed in different orders); bfloat16 5e-2 of the value
scale (bf16 activations round at other places in the two frameworks, and
the recurrence carries the rounding forward).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.engine.models import build_model as jax_build  # noqa: E402
from repro.engine.models import rglru as jrg  # noqa: E402
from repro.engine.models import xlstm as jxl  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.engine.models import build_model  # noqa: E402
from repro_torch.engine.models import rglru, xlstm  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU shapes gain nothing from torch's thread pool, and its
    spinning threads would slow the tests other workers run meanwhile."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = {"float32": 1e-4, "bfloat16": 5e-2}
LAYERS = 5
WINDOW = 16                                  # the smoke config's window


def _configs(dtype, impl="xla"):
    jcfg = jax_smoke("recurrentgemma-2b").replace(
        dtype=dtype, num_layers=LAYERS, attention_impl=impl)
    cfg = get_smoke("recurrentgemma-2b").replace(dtype=dtype,
                                                 num_layers=LAYERS)
    return jcfg, cfg


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    dtype = request.param
    jcfg, cfg = _configs(dtype)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), cfg))
    return dtype, jm, jp, tm


def _close(t, j, tol):
    a = t.float().numpy()
    b = np.asarray(j, np.float32)
    np.testing.assert_allclose(a, b, atol=tol * max(1.0, np.abs(b).max()),
                               rtol=tol)


def test_bridge_round_trip(models):
    dtype, jm, jp, tm = models
    groups, left = jp["groups"], jp["leftover"]
    pairs = [(tm.blocks[0].rg["w_a"], groups["b0"]["rg"]["w_a"][0]),
             (tm.blocks[1].w_in, groups["b1"]["w_in"][0]),
             (tm.blocks[2].attn["wq"], groups["b2"]["attn"]["wq"][0]),
             (tm.blocks[2].mlp["w_down"], groups["b2"]["mlp"]["w_down"][0]),
             (tm.blocks[3].conv_w, left[0]["conv_w"]),
             (tm.blocks[4].rg["lam"], left[1]["rg"]["lam"]),
             (tm.embed, jp["embed"])]
    for t, j in pairs:
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))
    assert tm.embed.dtype == getattr(torch, dtype)
    for name in ("b_a", "b_x", "lam"):            # f32 in the JAX init too
        assert tm.blocks[4].rg[name].dtype == torch.float32
    assert isinstance(tm.blocks[2], rglru.AttentionBlock)
    assert isinstance(tm.blocks[4], rglru.RecurrentBlock)


@pytest.mark.parametrize("impl,jimpl", [("torch", "xla"),
                                        ("cuda", "pallas_interpret")])
@pytest.mark.parametrize("S", [12, 2 * WINDOW])
def test_forward_prefill_and_decode_match_jax(models, impl, jimpl, S):
    dtype, jm, jp, tm = models
    tol = TOL[dtype]
    jm = jax_build(_configs(dtype, jimpl)[0])        # forward reads the cfg
    toks = ((np.arange(S) * 7 + 3) % 250).astype(np.int32)[None]
    jf, _ = jax.jit(jm.forward)(jp, jnp.asarray(toks))
    tf, aux = tm(torch.from_numpy(toks), impl=impl)
    _close(tf, jf, tol)
    assert float(aux) == 0.0
    jl, jc = jax.jit(jm.prefill, static_argnames="impl")(
        jp, jnp.asarray(toks), impl=jimpl)
    tl, tc = tm.prefill(torch.from_numpy(toks), impl=impl)
    _close(tl, jl, tol)
    assert sorted(tc) == sorted(jc)
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape, key
        _close(tc[key], jc[key], tol)
    assert tc["g0_lru"].dtype == torch.float32
    jc = jm.extend_cache(jc, 6)
    tc = tm.extend_cache(tc, 6)
    j_step = jax.jit(jm.decode_step, static_argnames="impl")
    for step in range(4):
        tok = np.asarray([(5 * step + 11) % 250], np.int32)
        jl, jc = j_step(jp, jnp.asarray(tok), jc, impl=jimpl)
        tl, tc = tm.decode_step(torch.from_numpy(tok), tc, impl=impl)
        _close(tl, jl, tol)
    for key in jc:
        _close(tc[key], jc[key], tol)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("S", [21, 37])
def test_ring_placement_past_the_window_equals_forward(impl, S):
    """Prefill S > window with S % window != 0, then decode: position p
    must sit in ring slot p % T, so the logits equal the teacher-forced
    forward at every position (the JAX reference's slots 0..T-1 do not)."""
    _, cfg = _configs("float32")
    jm = jax_build(_configs("float32")[0])
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1))), cfg))
    n_dec = 5
    toks = torch.from_numpy(
        ((np.arange(S + n_dec) * 13 + 1) % 250).astype(np.int64))[None]
    full, _ = tm(toks, impl=impl)
    logits, cache = tm.prefill(toks[:, :S], impl=impl)
    assert cache["g2_k"].shape[2] == WINDOW
    torch.testing.assert_close(logits, full[:, S - 1], atol=1e-4, rtol=1e-4)
    for i in range(n_dec):
        logits, cache = tm.decode_step(toks[:, S + i], cache, impl=impl)
        torch.testing.assert_close(logits, full[:, S + i], atol=1e-4,
                                   rtol=1e-4)
    assert int(cache["length"][0]) == S + n_dec


def test_rglru_core_and_conv_match_jax(models):
    dtype, jm, jp, tm = models
    tol = TOL[dtype]
    rng = np.random.default_rng(3)
    u = rng.normal(size=(2, 9, 64)).astype(np.float32)
    ju = jnp.asarray(u, jnp.dtype(dtype))
    tu = torch.from_numpy(u).to(getattr(torch, dtype))
    jrg_p = jax.tree.map(lambda a: a[0], jp["groups"]["b0"]["rg"])
    trg_p = tm.blocks[0].rg
    ja, jb = jrg.rglru_gates(jrg_p, ju)
    ta, tb = rglru.rglru_gates(trg_p, tu)
    _close(ta, ja, 1e-5)
    _close(tb, jb, 1e-5)
    for impl, jimpl in (("torch", "xla"), ("cuda", "pallas_interpret")):
        h = rglru.rglru_sequence(trg_p, tu, impl)
        assert h.dtype == torch.float32
        _close(h.to(tu.dtype), jrg.rglru_sequence(jrg_p, ju, jimpl), tol)
    h0 = rng.normal(size=(2, 64)).astype(np.float32)
    th, th32 = rglru.rglru_step(trg_p, tu[:, 0], torch.from_numpy(h0))
    jh, jh32 = jrg.rglru_step(jrg_p, ju[:, 0], jnp.asarray(h0))
    _close(th32, jh32, 1e-5)
    _close(th, jh, tol)
    w = tm.blocks[0].conv_w
    jw = jp["groups"]["b0"]["conv_w"][0]
    _close(xlstm.causal_conv1d(tu, w), jxl.causal_conv1d(ju, jw), tol)
    buf = tu[:, :3]
    ty, tbuf = xlstm.causal_conv1d_step(tu[:, 3], buf, w)
    jy, jbuf = jxl.causal_conv1d_step(ju[:, 3], ju[:, :3], jw)
    _close(ty, jy, tol)
    _close(tbuf, jbuf, 0.0)


def test_cache_axes_extend_and_slot_positions(models):
    """The dense-row hooks the engine drives, on a short prompt's cache:
    batch axes as JAX's, and extend_cache grows the ring to the window
    and no further."""
    _, jm, jp, tm = models
    toks = np.arange(3, 8, dtype=np.int32)[None]
    _, jc = jm.prefill(jp, jnp.asarray(toks), impl="xla")
    _, tc = tm.prefill(torch.from_numpy(toks), impl="torch")
    assert tm.cache_batch_axes(tc) == jm.cache_batch_axes(jc)
    assert tm.paged_kv_layout() is None
    assert tm.cache_capacity(100) == jm.cache_capacity(100) == WINDOW
    jc, tc = jm.extend_cache(jc, 30), tm.extend_cache(tc, 30)
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape, key
    assert tc["g2_k"].shape[2] == WINDOW
    assert tm.extend_cache(tc, 30)["g2_k"] is tc["g2_k"]
    for pos in ([0, 3, 15, 16, 40], [-1, 17, 31, 32, 5]):
        p = np.asarray(pos, np.int32)
        np.testing.assert_array_equal(
            tm._kv_slot_positions(torch.from_numpy(p), WINDOW).numpy(),
            np.asarray(jm._kv_slot_positions(jnp.asarray(p), WINDOW)))
