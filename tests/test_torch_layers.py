"""The port's layers against the JAX package's, on the CPU.

Inputs come from a numpy seed and go through both functions.  Tolerances:
f32 1e-5 (the frameworks' matmuls and transcendental functions round
differently in the last bits), bf16 2e-2 (one bf16 rounding, ~0.4%
relative, may land differently; values are O(1)).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.engine.models import layers as JL  # noqa: E402
from repro_torch.engine.models import layers as TL  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU shapes gain nothing from torch's thread pool, and its
    spinning threads would slow the tests other workers run meanwhile."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RNG = np.random.default_rng(3)
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(shape, dtype, scale=1.0):
    jd, td, _ = DTYPES[dtype]
    a = (RNG.normal(size=shape) * scale).astype(np.float32)
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _close(t, j, dtype):
    tol = DTYPES[dtype][2]
    assert t.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    x = _pair((2, 5, 64), dtype)
    w = _pair((64,), dtype, scale=0.1)
    _close(TL.rms_norm(x[1], w[1], 1e-6), JL.rms_norm(x[0], w[0], 1e-6),
           dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope(dtype):
    x = _pair((2, 7, 4, 16), dtype)
    pos = RNG.integers(0, 600, size=(2, 7)).astype(np.int32)
    _close(TL.apply_rope(x[1], torch.from_numpy(pos), 1e6),
           JL.apply_rope(x[0], jnp.asarray(pos), 1e6), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 5])
def test_plain_attention_matches_attention_xla(dtype, window):
    B, Sq, Skv, H, Hkv, Dh = 2, 6, 11, 4, 2, 16
    q, k, v = (_pair((B, Sq, H, Dh), dtype), _pair((B, Skv, Hkv, Dh), dtype),
               _pair((B, Skv, Hkv, Dh), dtype))
    qp = np.broadcast_to(np.arange(Skv - Sq, Skv), (B, Sq)).astype(np.int32)
    kp = np.broadcast_to(np.arange(Skv), (B, Skv)).astype(np.int32).copy()
    kp[1, -3:] = -1                                   # invalid slots
    out = TL.attention(q[1], k[1], v[1], q_positions=torch.from_numpy(qp),
                       kv_positions=torch.from_numpy(kp), window=window,
                       impl="torch")
    ref = JL.attention_xla(q[0], k[0], v[0], q_positions=jnp.asarray(qp),
                           kv_positions=jnp.asarray(kp), window=window)
    _close(out, ref, dtype)
    # the kernel impl takes the plain path on CPU tensors: same result
    out_k = TL.attention(q[1], k[1], v[1], q_positions=torch.from_numpy(qp),
                         kv_positions=torch.from_numpy(kp), window=window,
                         impl="cuda")
    assert torch.equal(out_k, out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_qkv_and_out(dtype):
    d, H, Hkv, Dh = 32, 4, 2, 8
    p = {n: _pair(s, dtype, 1 / np.sqrt(s[0])) for n, s in (
        ("wq", (d, H * Dh)), ("wk", (d, Hkv * Dh)), ("wv", (d, Hkv * Dh)),
        ("wo", (H * Dh, d)))}
    p["q_norm"] = _pair((Dh,), dtype, 0.1)
    p["k_norm"] = _pair((Dh,), dtype, 0.1)
    x = _pair((2, 5, d), dtype)
    pos = np.broadcast_to(np.arange(3, 8), (2, 5)).astype(np.int32)
    kw = dict(num_heads=H, num_kv_heads=Hkv, head_dim=Dh, rope_theta=1e6,
              qk_norm=True)
    tq = TL.attn_qkv({n: a[1] for n, a in p.items()}, x[1],
                     positions=torch.from_numpy(pos), **kw)
    jq = JL.attn_qkv({n: a[0] for n, a in p.items()}, x[0],
                     positions=jnp.asarray(pos), **kw)
    for a, b in zip(tq, jq):
        _close(a, b, dtype)
    o = _pair((2, 5, H, Dh), dtype)
    _close(TL.attn_out({"wo": p["wo"][1]}, o[1]),
           JL.attn_out({"wo": p["wo"][0]}, o[0]), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn_apply(dtype):
    d, ff = 32, 48
    p = {"w_gate": _pair((d, ff), dtype, 1 / np.sqrt(d)),
         "w_up": _pair((d, ff), dtype, 1 / np.sqrt(d)),
         "w_down": _pair((ff, d), dtype, 1 / np.sqrt(ff))}
    x = _pair((2, 5, d), dtype)
    _close(TL.ffn_apply({n: a[1] for n, a in p.items()}, x[1]),
           JL.ffn_apply({n: a[0] for n, a in p.items()}, x[0]), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl,jimpl", [("torch", "xla"),
                                        ("cuda", "pallas_interpret")])
def test_one_token_attention_over_a_ring(dtype, impl, jimpl):
    """Sq == 1 under "cuda" is the decode kernel's path (its plain version
    on CPU tensors), the Pallas decode kernel's under pallas_interpret."""
    B, T, H, Hkv, Dh = 3, 16, 4, 1, 32
    q = _pair((B, 1, H, Dh), dtype)
    k = _pair((B, T, Hkv, Dh), dtype)
    v = _pair((B, T, Hkv, Dh), dtype)
    qp = np.asarray([[37], [5], [16]], np.int32)
    slots = np.arange(T)[None, :]
    kp = qp - np.mod(qp - slots, T)
    kp = np.where(kp >= 0, kp, -1).astype(np.int32)
    out = TL.attention(q[1], k[1], v[1], q_positions=torch.from_numpy(qp),
                       kv_positions=torch.from_numpy(kp), window=10,
                       impl=impl)
    ref = JL.attention(q[0], k[0], v[0], q_positions=jnp.asarray(qp),
                       kv_positions=jnp.asarray(kp), window=10, impl=jimpl)
    assert tuple(out.shape) == (B, 1, H, Dh)
    _close(out, ref, dtype)
