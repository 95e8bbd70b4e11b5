"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with nvcc (marker ``cuda``) and skips
elsewhere; run them on the card with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
They import no JAX.  Tolerances: f32 2e-5 (the kernels sum in another
order than the plain versions), bf16 3e-2 (the plain flash version
rounds probs to bf16 before PV, the kernel keeps them in f32), and
bitwise where the JAX suite pins it (single == blocked, fused ==
scatter-then-attend) or the kernel rounds exactly as its plain version
(the RG-LRU scan: a multiply, then an add, per step).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.common import NEG_INF  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref, lse_combine)
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref)
from repro_torch.kernels.paged_decode_attention import (  # noqa: E402
    ops as pd_ops)
from repro_torch.kernels.paged_decode_attention.ref import (  # noqa: E402
    paged_decode_attention_ref, scatter_append_ref)
from repro_torch.kernels.rglru_scan import ops as lru_ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import linear_scan_ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _t(a, dtype, dev):
    return torch.as_tensor(np.asarray(a, np.float32)).to(dev, dtype)


def _tol(dtype):
    return 2e-5 if dtype == torch.float32 else 3e-2


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,Dh", [
    (1, 32, 32, 2, 2, 8), (2, 64, 64, 4, 2, 16), (2, 16, 64, 8, 1, 32),
    (1, 48, 80, 16, 8, 128), (1, 40, 72, 10, 1, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 24])
def test_flash_kernel_matches_plain(dev, B, Sq, Skv, H, Hkv, Dh, dtype,
                                    window):
    rng = np.random.default_rng(7)
    q = _t(rng.normal(size=(B, Sq, H, Dh)), dtype, dev)
    k = _t(rng.normal(size=(B, Skv, Hkv, Dh)), dtype, dev)
    v = _t(rng.normal(size=(B, Skv, Hkv, Dh)), dtype, dev)
    qp = torch.arange(Skv - Sq, Skv, dtype=torch.int32,
                      device=dev).expand(B, Sq).contiguous()
    kp = torch.arange(Skv, dtype=torch.int32, device=dev).expand(
        B, Skv).contiguous()
    qp[0, 0] = -1                  # a row with no valid key: mean(V)
    n0 = fa_ops.launches
    out = fa_ops.flash_attention(q, k, v, q_positions=qp, kv_positions=kp,
                                 causal=True, window=window)
    torch.cuda.synchronize()
    assert fa_ops.launches == n0 + 1
    ref = flash_attention_ref(q, k, v, q_positions=qp, kv_positions=kp,
                              causal=True, window=window)
    tol = _tol(dtype)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    mean_v = v[0].float().mean(dim=0).repeat_interleave(H // Hkv, dim=0)
    torch.testing.assert_close(out[0, 0].float(), mean_v, atol=tol,
                               rtol=tol)


def _paged_case(dev, B=3, NP=5, ps=8, H=4, Hkv=2, Dh=16, seed=11,
                q_dtype=torch.float32, pool_dtype=torch.float32):
    """Shuffled pool, lengths ending mid-page, rows 0/1 aliasing their
    first two pages, and one padding row."""
    rng = np.random.default_rng(seed)
    P = 2 * B * NP
    q = _t(rng.normal(size=(B, H, Dh)), q_dtype, dev)
    kp = _t(rng.normal(size=(P, ps, Hkv, Dh)), pool_dtype, dev)
    vp = _t(rng.normal(size=(P, ps, Hkv, Dh)), pool_dtype, dev)
    pt = np.asarray(rng.permutation(P)[:B * NP].reshape(B, NP), np.int32)
    pt[1, :2] = pt[0, :2]
    lens = np.asarray(rng.integers(2 * ps + 1, NP * ps - 2, size=(B,)),
                      np.int32)
    lens = np.where(lens % ps == 0, lens + 1, lens)
    lens[-1] = -1
    return (q, kp, vp, torch.as_tensor(pt).to(dev),
            torch.as_tensor(lens).to(dev))


@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_paged_single_matches_plain_and_blocked_is_bitwise(dev, q_dtype,
                                                           pool_dtype):
    q, kp, vp, pt, lens = _paged_case(dev, q_dtype=q_dtype,
                                      pool_dtype=pool_dtype)
    base, m, l = pd_ops.paged_decode_attention(
        q, kp, vp, pt, lens, variant="single", return_lse=True)
    ref, mr, lr = paged_decode_attention_ref(q, kp, vp, pt, lens,
                                             return_lse=True)
    tol = _tol(q_dtype)
    torch.testing.assert_close(base.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(m, mr, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(l, lr, atol=2e-5, rtol=2e-5)
    # the padding row is pinned exactly
    assert torch.all(base[-1] == 0)
    assert torch.all(m[-1] == NEG_INF) and torch.all(l[-1] == 0)
    for ppb in (2, 3, 4, 8):
        out = pd_ops.paged_decode_attention(q, kp, vp, pt, lens,
                                            variant="blocked",
                                            pages_per_block=ppb)
        assert torch.equal(out, base), ppb


@pytest.mark.parametrize("ppb", [1, 2, 3, 4])
def test_fused_equals_scatter_then_attend_bitwise(dev, ppb):
    q, kp, vp, pt, lens = _paged_case(dev, seed=13)
    rng = np.random.default_rng(99)
    k_new = _t(rng.normal(size=(3, 2, 16)), torch.float32, dev)
    v_new = _t(rng.normal(size=(3, 2, 16)), torch.float32, dev)
    ks, vs = scatter_append_ref(kp.clone(), vp.clone(), pt, lens, k_new,
                                v_new)
    base = pd_ops.paged_decode_attention(q, ks, vs, pt, lens,
                                         variant="blocked",
                                         pages_per_block=ppb)
    out, k_out, v_out = pd_ops.fused_paged_decode_attention(
        q, kp, vp, pt, lens, k_new, v_new, pages_per_block=ppb)
    assert torch.equal(out, base)
    assert torch.equal(k_out, ks) and torch.equal(v_out, vs)
    assert k_out.data_ptr() == kp.data_ptr()          # in place


def test_fused_padding_row_writes_nothing(dev):
    q, kp, vp, pt, lens = _paged_case(dev, seed=17)
    k_new = torch.full((3, 2, 16), 1e6, device=dev)
    v_new = torch.full((3, 2, 16), -1e6, device=dev)
    ks, vs = scatter_append_ref(kp.clone(), vp.clone(), pt, lens, k_new,
                                v_new)
    _, k_out, v_out = pd_ops.fused_paged_decode_attention(
        q, kp, vp, pt, lens, k_new, v_new, pages_per_block=2)
    assert torch.equal(k_out, ks) and torch.equal(v_out, vs)
    for pg in pt[-1].tolist():
        assert not torch.any(k_out[pg] == 1e6)
        assert not torch.any(v_out[pg] == -1e6)


def test_fused_main_path_shape(dev):
    """B=8 rows of 65 live pages, page 8, Hkv 8, Dh 128, G 2, bf16 q over
    an f32 pool: the engine's full-width decode step."""
    rng = np.random.default_rng(5)
    B, NP, ps, H, Hkv, Dh = 8, 65, 8, 16, 8, 128
    P = B * NP + 8
    q = _t(rng.normal(size=(B, H, Dh)), torch.bfloat16, dev)
    kp = _t(rng.normal(size=(P, ps, Hkv, Dh)), torch.bfloat16, dev).float()
    vp = _t(rng.normal(size=(P, ps, Hkv, Dh)), torch.bfloat16, dev).float()
    pt = torch.as_tensor(rng.permutation(P)[:B * NP].reshape(B, NP),
                         dtype=torch.int32).to(dev)
    lens = torch.full((B,), NP * ps - 3, dtype=torch.int32, device=dev)
    k_new = _t(rng.normal(size=(B, Hkv, Dh)), torch.bfloat16, dev).float()
    v_new = _t(rng.normal(size=(B, Hkv, Dh)), torch.bfloat16, dev).float()
    ks, vs = scatter_append_ref(kp.clone(), vp.clone(), pt, lens, k_new,
                                v_new)
    ref = paged_decode_attention_ref(q, ks, vs, pt, lens)
    out, k_out, _ = pd_ops.fused_paged_decode_attention(
        q, kp, vp, pt, lens, k_new, v_new)
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2,
                               rtol=3e-2)
    assert torch.equal(k_out, ks)


def _ring_case(dev, B, T, H, Hkv, Dh, dtype, seed=3):
    """A ring cache of T slots, position p in slot p % T: row 0 has
    wrapped (its newest position is past T), row 1 has not (its tail
    slots are empty, -1), and the last row has no valid key at all."""
    rng = np.random.default_rng(seed)
    q = _t(rng.normal(size=(B, H, Dh)), dtype, dev)
    k = _t(rng.normal(size=(B, T, Hkv, Dh)), dtype, dev)
    v = _t(rng.normal(size=(B, T, Hkv, Dh)), dtype, dev)
    qp = rng.integers(0, 3 * T, size=(B,))
    qp[0], qp[1] = 2 * T + 3, T // 2
    slots = np.arange(T)[None, :]
    kp = qp[:, None] - np.mod(qp[:, None] - slots, T)
    kp = np.where(kp >= 0, kp, -1)
    kp[-1] = -1                                # a row with no valid key
    return (q, k, v, torch.as_tensor(qp, dtype=torch.int32).to(dev),
            torch.as_tensor(kp, dtype=torch.int32).to(dev))


@pytest.mark.parametrize("B,T,H,Hkv,Dh", [
    (3, 40, 2, 2, 32), (3, 100, 4, 2, 128), (4, 96, 10, 1, 256),
    (3, 70, 16, 1, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 17])
def test_decode_kernel_matches_plain(dev, B, T, H, Hkv, Dh, dtype, window):
    q, k, v, qp, kp = _ring_case(dev, B, T, H, Hkv, Dh, dtype)
    n0 = da_ops.launches
    out, m, l = da_ops.decode_attention(q, k, v, q_positions=qp,
                                        kv_positions=kp, window=window,
                                        return_lse=True)
    torch.cuda.synchronize()
    assert da_ops.launches == n0 + 1
    ref, mr, lr = decode_attention_ref(q, k, v, q_positions=qp,
                                       kv_positions=kp, window=window,
                                       return_lse=True)
    tol = _tol(dtype)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(m, mr, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(l, lr, atol=2e-5, rtol=2e-5)
    # the row with no valid key is pinned exactly
    assert torch.all(out[-1] == 0)
    assert torch.all(m[-1] == NEG_INF) and torch.all(l[-1] == 0)


def test_decode_kernel_halves_combine_to_the_whole(dev):
    q, k, v, qp, kp = _ring_case(dev, 3, 128, 10, 1, 256, torch.float32)
    whole = da_ops.decode_attention(q, k, v, q_positions=qp,
                                    kv_positions=kp, window=50)
    parts = [da_ops.decode_attention(
        q, k[:, lo:lo + 64].contiguous(), v[:, lo:lo + 64].contiguous(),
        q_positions=qp, kv_positions=kp[:, lo:lo + 64].contiguous(),
        window=50, return_lse=True) for lo in (0, 64)]
    torch.testing.assert_close(lse_combine(parts), whole, atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("B,S,D", [(2, 37, 70), (3, 5, 1), (1, 384, 2560)])
def test_scan_kernel_equals_plain_bitwise(dev, B, S, D):
    rng = np.random.default_rng(B * S + D)
    a = torch.as_tensor(rng.uniform(0.5, 1.0, size=(B, S, D)),
                        dtype=torch.float32).to(dev)
    b = torch.as_tensor(rng.normal(size=(B, S, D)),
                        dtype=torch.float32).to(dev)
    n0 = lru_ops.launches
    h = lru_ops.linear_scan(a, b)
    torch.cuda.synchronize()
    assert lru_ops.launches == n0 + 1
    assert torch.equal(h, linear_scan_ref(a, b))
