"""The port's backward kernels' plain versions against JAX's gradients.

The JAX package trains through XLA attention and the associative scan;
the port trains through its flash and scan kernels, each with a
hand-written backward whose plain version runs on the CPU.  Here, on the
same inputs drawn from numpy seeds, in float32:

* ``flash_attention_bwd_ref`` and the autograd ``FlashAttention`` (the
  plain versions on the CPU) against ``jax.vjp`` of the JAX package's
  ``attention_xla`` and of its ``flash_attention_ref``, within 1e-5 of the
  gradient's scale: causal GQA, a window, non-causal, invalid (-1) keys,
  and rows with no valid key (dQ = 0, nothing to dK, dO/Skv to every dV);
* the scan's backward (``linear_scan_bwd_ref`` and ``LinearScan``) against
  ``jax.vjp`` of the associative scan the JAX model runs and of its
  sequential oracle;
* the decode-side kernels, which have no backward, refuse inputs that
  require grad before they launch, so no gradient is dropped silently.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.engine.models.layers import attention_xla  # noqa: E402
from repro.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref as jax_flash_ref)
from repro.kernels.rglru_scan.ref import (  # noqa: E402
    linear_scan_ref as jax_scan_ref)
from repro_torch.kernels.common import refuse_grad  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_lse_ref, flash_attention_ref)
from repro_torch.kernels.paged_decode_attention import (  # noqa: E402
    ops as pd_ops)
from repro_torch.kernels.rglru_scan import ops as lru_ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import (  # noqa: E402
    linear_scan_bwd_ref, linear_scan_ref)
from repro_torch.kernels.shared_prefix_attention import (  # noqa: E402
    ops as sp_ops)

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(t, j, tol=TOL):
    a = t.detach().float().numpy()
    b = np.asarray(j, np.float32)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, atol=tol * scale, rtol=tol)


# (B, Sq, Skv, H, Hkv, Dh, causal, window, positions)
CASES = {
    "causal_gqa": (2, 12, 12, 4, 2, 16, True, 0, "arange"),
    "window": (2, 10, 14, 6, 2, 8, True, 5, "suffix"),
    "non_causal": (2, 7, 11, 3, 3, 8, False, 0, "arange"),
    "invalid_keys": (2, 9, 13, 4, 1, 16, True, 0, "holes"),
    "no_valid_key_rows": (2, 8, 10, 4, 2, 8, True, 3, "empty_rows"),
}


def _inputs(name, seed=0):
    B, Sq, Skv, H, Hkv, Dh, causal, window, pos = CASES[name]
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    q, k, v, do = f(B, Sq, H, Dh), f(B, Skv, Hkv, Dh), f(B, Skv, Hkv, Dh), \
        f(B, Sq, H, Dh)
    kp = np.tile(np.arange(Skv, dtype=np.int32), (B, 1))
    qp = np.tile(np.arange(Skv - Sq, Skv, dtype=np.int32), (B, 1))
    if pos == "arange":
        qp = np.tile(np.arange(Sq, dtype=np.int32), (B, 1))
    elif pos == "holes":
        kp[0, [1, 4, 5]] = -1
        kp[1, -3:] = -1
    elif pos == "empty_rows":
        qp[0, 0] = -1                       # before every key
        qp[1, 2] = -1
        kp[1, :4] = -1
    return dict(q=q, k=k, v=v, do=do, qp=qp, kp=kp, causal=causal,
                window=window)


def _jax_grads(fn, x):
    def f(q, k, v):
        return fn(q, k, v, q_positions=jnp.asarray(x["qp"]),
                  kv_positions=jnp.asarray(x["kp"]), causal=x["causal"],
                  window=x["window"])
    _, vjp = jax.vjp(f, *(jnp.asarray(x[n]) for n in "qkv"))
    return vjp(jnp.asarray(x["do"]))


def _torch(x, requires_grad=False):
    t = {n: torch.from_numpy(x[n]).requires_grad_(requires_grad)
         for n in "qkv"}
    t["do"] = torch.from_numpy(x["do"])
    t["qp"], t["kp"] = torch.from_numpy(x["qp"]), torch.from_numpy(x["kp"])
    return t


@pytest.mark.parametrize("jax_fn", ["attention_xla", "flash_attention_ref"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_bwd_ref_equals_jax_vjp(case, jax_fn):
    x = _inputs(case)
    jq, jk, jv = _jax_grads({"attention_xla": attention_xla,
                             "flash_attention_ref": jax_flash_ref}[jax_fn], x)
    t = _torch(x)
    dq, dk, dv = flash_attention_bwd_ref(
        t["q"], t["k"], t["v"], t["do"], q_positions=t["qp"],
        kv_positions=t["kp"], causal=x["causal"], window=x["window"])
    for a, b in ((dq, jq), (dk, jk), (dv, jv)):
        _close(a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_autograd_function_equals_jax_vjp(case):
    """Through ``fa_ops.flash_attention`` with grad on: the ``Function``'s
    CPU forward and backward are the plain versions."""
    x = _inputs(case, seed=1)
    jq, jk, jv = _jax_grads(attention_xla, x)
    t = _torch(x, requires_grad=True)
    out = fa_ops.flash_attention(t["q"], t["k"], t["v"], q_positions=t["qp"],
                                 kv_positions=t["kp"], causal=x["causal"],
                                 window=x["window"])
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    _close(out, flash_attention_ref(t["q"], t["k"], t["v"],
                                    q_positions=t["qp"],
                                    kv_positions=t["kp"],
                                    causal=x["causal"],
                                    window=x["window"]).detach())
    out.backward(t["do"])
    for n, j in (("q", jq), ("k", jk), ("v", jv)):
        _close(t[n].grad, j)


def test_rows_without_a_valid_key_get_no_dq_and_send_do_over_skv_to_dv():
    """The forward gives such a row the uniform mean of V: its logits were
    masked by a ``where``, so dQ = 0 and it adds nothing to dK, and each
    key's dV takes dO/Skv from it."""
    x = _inputs("no_valid_key_rows", seed=2)
    B, Sq, Skv, H, Hkv, Dh = 2, 8, 10, 4, 2, 8
    t = _torch(x)
    # only the empty rows carry an output gradient
    do = torch.zeros_like(t["do"])
    do[0, 0] = t["do"][0, 0]
    dq, dk, dv = flash_attention_bwd_ref(
        t["q"], t["k"], t["v"], do, q_positions=t["qp"],
        kv_positions=t["kp"], causal=True, window=3)
    assert torch.all(dq == 0) and torch.all(dk == 0)
    G = H // Hkv
    want = do[0, 0].reshape(Hkv, G, Dh).sum(1) / Skv
    torch.testing.assert_close(dv[0], want[None].expand(Skv, Hkv, Dh),
                               atol=1e-6, rtol=1e-6)
    assert torch.all(dv[1] == 0)


def test_lse_ref_is_the_log_normalizer_and_marks_rows_without_a_key():
    """exp(logits - lse) sums to 1 over a row's valid keys; a row with none
    carries NEG_INF, the mark the backward reads."""
    x = _inputs("no_valid_key_rows", seed=4)
    t = _torch(x)
    kw = dict(q_positions=t["qp"], kv_positions=t["kp"], causal=True,
              window=3)
    lse = flash_attention_lse_ref(t["q"], t["k"], **kw)
    jl = jax.nn.logsumexp(
        jnp.where(_jax_mask(x), _jax_logits(x), -jnp.inf), axis=-1)
    B, Sq, H = t["q"].shape[:3]
    jl = np.asarray(jl).reshape(B, H, Sq)
    empty = ~np.isfinite(jl)
    assert empty[0, :, 0].all() and empty[1, :, 2].all()
    assert torch.all(lse[torch.from_numpy(empty)] == -1e30)
    _close(lse[torch.from_numpy(~empty)], jl[~empty])
    out, lse2 = fa_ops.flash_attention_lse(t["q"], t["k"], t["v"], **kw)
    assert torch.equal(lse2, lse)
    assert torch.equal(out, flash_attention_ref(t["q"], t["k"], t["v"], **kw))


def _jax_logits(x):
    B, Sq, H, Dh = x["q"].shape
    Hkv = x["k"].shape[2]
    qg = x["q"].reshape(B, Sq, Hkv, H // Hkv, Dh)
    return jnp.einsum("bqhgd,bkhd->bhgqk", qg, x["k"]) / np.sqrt(Dh)


def _jax_mask(x):
    qp = x["qp"][:, None, None, :, None]
    kp = x["kp"][:, None, None, None, :]
    mask = (kp >= 0) & (kp <= qp)
    if x["window"]:
        mask = mask & (kp > qp - x["window"])
    return mask


def test_flash_without_grad_is_the_direct_call():
    """With grad off, or inputs that need none, no ``Function`` wraps the
    call: the serving path is unchanged."""
    t = _torch(_inputs("causal_gqa"))
    kw = dict(q_positions=t["qp"], kv_positions=t["kp"])
    assert fa_ops.flash_attention(t["q"], t["k"], t["v"], **kw).grad_fn \
        is None
    q = t["q"].clone().requires_grad_(True)
    with torch.no_grad():
        assert fa_ops.flash_attention(q, t["k"], t["v"], **kw).grad_fn is None


def test_flash_backward_refuses_head_dims_it_has_no_body_for():
    for Dh in fa_ops.BWD_HEAD_DIMS:
        fa_ops._check_bwd_shape(torch.zeros(1, 1, 2, Dh),
                                torch.zeros(1, 1, 1, Dh))
    for Dh in (8, 16, 32):
        with pytest.raises(ValueError, match="head_dim"):
            fa_ops._check_bwd_shape(torch.zeros(1, 1, 2, Dh),
                                    torch.zeros(1, 1, 1, Dh))


# ------------------------------------------------------------------ scan

def _assoc_scan(a, b):
    """The JAX model's sequence recurrence (``rglru_sequence`` under
    ``"xla"``): an associative scan of the (a, b) pairs over time."""
    def combine(e1, e2):
        a1, b1 = e1
        a2, b2 = e2
        return a1 * a2, a2 * b1 + b2
    return lax.associative_scan(combine, (a, b), axis=1)[1]


@pytest.mark.parametrize("jax_fn", ["associative", "sequential"])
@pytest.mark.parametrize("B,S,D", [(2, 17, 12), (1, 1, 5), (3, 40, 7)])
def test_scan_bwd_equals_jax_vjp(B, S, D, jax_fn):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, size=(B, S, D)).astype(np.float32)
    b = rng.normal(size=(B, S, D)).astype(np.float32)
    dh = rng.normal(size=(B, S, D)).astype(np.float32)
    fn = _assoc_scan if jax_fn == "associative" else jax_scan_ref
    _, vjp = jax.vjp(fn, jnp.asarray(a), jnp.asarray(b))
    ja, jb = vjp(jnp.asarray(dh))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    h = linear_scan_ref(ta, tb)
    da, db = linear_scan_bwd_ref(ta, h, torch.from_numpy(dh))
    _close(da, ja)
    _close(db, jb)
    # through the wrapper with grad on: the LinearScan Function
    ta.requires_grad_(True)
    tb.requires_grad_(True)
    out = lru_ops.linear_scan(ta, tb)
    assert type(out.grad_fn).__name__ == "LinearScanBackward"
    out.backward(torch.from_numpy(dh))
    _close(ta.grad, ja)
    _close(tb.grad, jb)


# ------------------------------------------------- kernels with no backward

def test_refuse_grad_raises_only_with_grad_on_and_an_input_needing_it():
    x = torch.zeros(2, requires_grad=True)
    y = torch.zeros(2)
    with pytest.raises(RuntimeError, match="no backward"):
        refuse_grad("k", y, x)
    refuse_grad("k", y, None)
    with torch.no_grad():
        refuse_grad("k", x)


def test_decode_side_launches_refuse_inputs_that_require_grad():
    """The decode, paged and prefix wrappers check for grad before
    anything else of a launch, so on the card such a call raises rather
    than return an output with no ``grad_fn``; under ``no_grad`` the same
    call goes on (here to the device check, on the CPU)."""
    B, H, Hkv, Dh, T = 2, 4, 2, 16, 8
    q = torch.zeros(B, H, Dh, requires_grad=True)
    kv = torch.zeros(B, T, Hkv, Dh)
    pos = torch.zeros(B, dtype=torch.int32)
    kvp = torch.zeros(B, T, dtype=torch.int32)
    pages = torch.zeros(4, 8, Hkv, Dh)
    table = torch.zeros(B, 2, dtype=torch.int32)
    prefix = torch.zeros(5, Hkv, Dh)
    calls = {
        "decode_attention": lambda: da_ops._launch(q, kv, kv, pos, kvp, 0),
        "paged_decode_attention": lambda: pd_ops._launch(
            q, pages, pages, table, pos, None, None, 1, "single"),
        "prefix_attention": lambda: sp_ops._launch(q, prefix, prefix, None),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name}: the CUDA kernel "
                           "has no backward"):
            call()
        with torch.no_grad(), pytest.raises(ValueError,
                                            match="unsupported device"):
            call()

