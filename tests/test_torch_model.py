"""The port's TransformerLM against the JAX package's, on bridged weights.

``get_smoke("qwen3-1.7b")`` weights are made by the JAX init and bridged
into the port, once in float32 (the algorithm) and once in bfloat16 (the
working type).  Each case runs prefill, the chunked prefill with
``valid_len`` padding and one paged decode step on both models, the port
under ``torch`` against JAX ``xla`` and under ``cuda`` (the plain kernel
versions, on CPU tensors) against JAX ``pallas_interpret``.

Tolerances: float32 1e-4 on logits and KV (3 layers of f32 matmuls summed
in different orders); bfloat16 5e-2 (bf16 activations round at slightly
different places in the two frameworks).  Padding of the chunked prefill
must be bitwise invisible, and the pages the decode step did not write
must be bitwise untouched.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.engine.kvcache import PagedKVCache as JaxKV  # noqa: E402
from repro.engine.models import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.engine.kvcache import PagedKVCache  # noqa: E402
from repro_torch.engine.models import build_model  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU shapes gain nothing from torch's thread pool, and its
    spinning threads would slow the tests other workers run meanwhile."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = {"float32": 1e-4, "bfloat16": 5e-2}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    dtype = request.param
    jcfg = jax_smoke("qwen3-1.7b").replace(dtype=dtype)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_smoke("qwen3-1.7b").replace(dtype=dtype)
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), cfg))
    return dtype, jm, jp, tm


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def test_bridge_round_trip(models):
    dtype, jm, jp, tm = models
    np.testing.assert_array_equal(
        tm.blocks[1].attn["wk"].float().numpy(),
        np.asarray(jp["blocks"]["attn"]["wk"][1], np.float32))
    np.testing.assert_array_equal(tm.embed.float().numpy(),
                                  np.asarray(jp["embed"], np.float32))
    assert tm.embed.dtype == getattr(torch, dtype)


@pytest.mark.parametrize("impl,jimpl", [("torch", "xla"),
                                        ("cuda", "pallas_interpret")])
def test_prefill_chunked_prefill_and_paged_step_match_jax(models, impl,
                                                          jimpl):
    dtype, jm, jp, tm = models
    tol = TOL[dtype]
    toks = np.arange(10, 23, dtype=np.int32)[None]          # 13 tokens
    S, P, T = 13, 7, 32

    # teacher-forced forward and monolithic prefill
    jf, _ = jm.forward(jp, jnp.asarray(toks))
    tf, aux = tm(torch.from_numpy(toks), impl=impl)
    _close(tf, jf, tol)
    assert float(aux) == 0.0
    jl, jc = jm.prefill(jp, jnp.asarray(toks), impl=jimpl)
    tl, tc = tm.prefill(torch.from_numpy(toks), impl=impl)
    _close(tl, jl, tol)
    _close(tc["k"], jc["k"], tol)

    # chunked prefill of tokens P..S over a cached prefix, right-padded
    # to 16 with valid_len (the engine's bucketed shape)
    k_pre, v_pre = tm.cache_kv_rows(tm.prefill(torch.from_numpy(
        toks[:, :P]), impl=impl)[1], 0)
    L_, _, H, D = k_pre.shape
    k_rows = np.zeros((1, L_, T, H, D), np.float32)
    v_rows = np.zeros_like(k_rows)
    k_rows[0, :, :P], v_rows[0, :, :P] = k_pre, v_pre
    chunk = np.zeros((1, 16), np.int32)
    chunk[0, :S - P] = toks[0, P:]
    n = np.asarray([S - P], np.int32)
    jl2, jc2 = jm.prefill_with_cache(
        jp, jnp.asarray(chunk), jm.paged_cache_view(k_rows, v_rows, [P]),
        impl=jimpl, valid_len=jnp.asarray(n))
    tl2, tc2 = tm.prefill_with_cache(
        torch.from_numpy(chunk), tm.paged_cache_view(k_rows, v_rows, [P]),
        impl=impl, valid_len=torch.from_numpy(n))
    _close(tl2, jl2, tol)
    _close(tc2["k"][:, :, :S], jc2["k"][:, :, :S], tol)
    assert int(tc2["length"][0]) == S
    # the padding is bitwise invisible: the unpadded chunk gives the same
    tl3, tc3 = tm.prefill_with_cache(
        torch.from_numpy(toks[:, P:].copy()),
        tm.paged_cache_view(k_rows, v_rows, [P]), impl=impl)
    assert torch.equal(tl3, tl2)
    assert torch.equal(tc3["k"][:, :, :S], tc2["k"][:, :, :S])

    # one paged decode step over pools holding the prompt's KV
    layers, heads, dh = tm.paged_kv_layout()
    jkv = JaxKV(layers, num_pages=8, page_size=8, kv_heads=heads,
                head_dim=dh)
    tkv = PagedKVCache(layers, num_pages=8, page_size=8, kv_heads=heads,
                       head_dim=dh, device="cpu")
    k_all, v_all = tm.cache_kv_rows(tc, 0)
    jseq = jkv.add_sequence(k_all, v_all)
    tseq = tkv.add_sequence(k_all, v_all)
    assert jkv.prepare_append(jseq) == tkv.prepare_append(tseq)
    pt = np.asarray([jkv.page_table(jseq), [0, 0]], np.int32)
    lens = np.asarray([S, -1], np.int32)                 # + a padding row
    tok = np.asarray([42, 0], np.int32)
    jlg, jk, jv = jm.paged_decode_step(
        jp, jnp.asarray(tok), jkv.k, jkv.v, jnp.asarray(pt),
        jnp.asarray(lens), impl=jimpl)
    k_before = tkv.k.clone()
    tlg, tk, tv = tm.paged_decode_step(
        torch.from_numpy(tok), tkv.k, tkv.v, torch.from_numpy(pt),
        torch.from_numpy(lens), impl=impl)
    assert tk is tkv.k and tv is tkv.v                   # in place
    _close(tlg[0], jlg[0], tol)
    _close(tk, jk, tol)
    _close(tv, jv, tol)
    written = torch.zeros_like(tk, dtype=torch.bool)
    written[:, pt[0, S // 8], S % 8] = True
    assert torch.equal(tk[~written], k_before[~written])


@pytest.mark.parametrize("impl,jimpl", [("torch", "xla"),
                                        ("cuda", "pallas_interpret")])
def test_dense_decode_step_and_kv_taps_match_jax(models, impl, jimpl):
    """The engine's dense-view arm: decode steps over a dense cache grown
    past the prompt, batched with a shorter row, and the K/V taps each
    step appends back to the pages."""
    dtype, jm, jp, tm = models
    tol = TOL[dtype]
    toks = np.arange(10, 23, dtype=np.int32)[None]           # 13 tokens
    short = np.arange(40, 47, dtype=np.int32)[None]          # 7 tokens
    jrows, k_rows, v_rows, lens = [], [], [], []
    for prompt in (toks, short):
        _, jc = jm.prefill(jp, jnp.asarray(prompt), impl=jimpl)
        _, tc = tm.prefill(torch.from_numpy(prompt), impl=impl)
        S = prompt.shape[1]
        jrows.append(jm.extend_cache(jc, 32 - S))
        # the engine's view: page rows (B, L, T, Hkv, Dh), zero past length
        k_rows.append(F.pad(tc["k"][:, 0], (0, 0, 0, 0, 0, 32 - S)))
        v_rows.append(F.pad(tc["v"][:, 0], (0, 0, 0, 0, 0, 32 - S)))
        lens.append(S)
    jc = {k: jnp.concatenate([c[k] for c in jrows],
                             axis=jm.cache_batch_axes(jrows[0])[k])
          for k in jrows[0]}
    tc = tm.paged_cache_view(torch.stack(k_rows), torch.stack(v_rows), lens)
    assert tuple(tc["k"].shape) == jc["k"].shape
    _close(tc["k"], jc["k"], tol)
    tok = np.asarray([42, 7], np.int32)
    for _ in range(2):
        lengths = np.asarray(jc["length"])
        jl, jc = jm.decode_step(jp, jnp.asarray(tok), jc, impl=jimpl)
        tl, tc = tm.decode_step(torch.from_numpy(tok), tc, impl=impl)
        _close(tl, jl, tol)
        jk, jv = jm.decode_kv_taps(jc, lengths)
        tk, tv = tm.decode_kv_taps(tc, lengths.tolist())
        _close(tk, jk, tol)
        _close(tv, jv, tol)
        tok = np.asarray(torch.argmax(tl, -1), np.int32)
    assert tc["length"].tolist() == [15, 9]
