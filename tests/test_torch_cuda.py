"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with nvcc (marker ``cuda``) and skips
elsewhere; run them on the card with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
They import no JAX.  Tolerances: f32 2e-5 (the kernels sum in another
order than the plain versions), bf16 3e-2 (the plain flash version
rounds probs to bf16 before PV, the kernel keeps them in f32), and
bitwise where the JAX suite pins it (single == blocked, fused ==
scatter-then-attend) or the kernel rounds exactly as its plain version
(the RG-LRU scan: a multiply, then an add, per step, and so its
backward, the same scan walked backwards in one kernel).  The flash
backward (bf16 on the tensor cores, f32 on the CUDA cores): in f32 within
1e-4 of each gradient's scale; in bf16 every element within 2e-3 +
8e-3 |ref| and the RMS error within 5% of the reference's RMS; two calls
on the same inputs bitwise equal.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.common import NEG_INF  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref, lse_combine)
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_ref)
from repro_torch.kernels.paged_decode_attention import (  # noqa: E402
    ops as pd_ops)
from repro_torch.kernels.paged_decode_attention.ref import (  # noqa: E402
    paged_decode_attention_ref, scatter_append_ref)
from repro_torch.kernels.rglru_scan import ops as lru_ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import (  # noqa: E402
    linear_scan_bwd_ref, linear_scan_ref)
from repro_torch.kernels.shared_prefix_attention import (  # noqa: E402
    ops as sp_ops)
from repro_torch.kernels.shared_prefix_attention.ref import (  # noqa: E402
    prefix_attention_ref, shared_prefix_attention_ref)

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


def _flash_case(dev, B, Sq, Skv, H, Hkv, Dh, dtype, seed):
    rng = np.random.default_rng(seed)
    q = _t(rng.normal(size=(B, Sq, H, Dh)), dtype, dev)
    k = _t(rng.normal(size=(B, Skv, Hkv, Dh)), dtype, dev)
    v = _t(rng.normal(size=(B, Skv, Hkv, Dh)), dtype, dev)
    return q, k, v, rng


def _flash_check(dev, q, k, v, qp, kp, window, dtype, *, tensor_cores):
    n0 = (fa_ops.tensor_core_launches, fa_ops.cuda_core_launches)
    out = fa_ops.flash_attention(q, k, v, q_positions=qp, kv_positions=kp,
                                 causal=True, window=window)
    torch.cuda.synchronize()
    n1 = (fa_ops.tensor_core_launches, fa_ops.cuda_core_launches)
    assert n1 == ((n0[0] + 1, n0[1]) if tensor_cores
                  else (n0[0], n0[1] + 1))
    ref = flash_attention_ref(q, k, v, q_positions=qp, kv_positions=kp,
                              causal=True, window=window)
    tol = _tol(dtype)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    return out


@pytest.mark.parametrize("H,Hkv,Dh", [(16, 8, 128), (10, 1, 256),
                                      (4, 2, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 29])
def test_flash_unsorted_positions_with_empty_slots(dev, H, Hkv, Dh, dtype,
                                                   window):
    """kv_positions permuted per row with scattered -1 slots, Sq and Skv
    no multiple of any tile: the tile-skipping rule reads min/max per tile
    and must not assume sorted positions."""
    B, Sq, Skv = 2, 100, 203
    q, k, v, rng = _flash_case(dev, B, Sq, Skv, H, Hkv, Dh, dtype, 31)
    kp = np.stack([rng.permutation(Skv) for _ in range(B)])
    kp[rng.random(size=kp.shape) < 0.15] = -1
    qp = np.stack([np.sort(rng.choice(Skv, Sq, replace=False))
                   for _ in range(B)])
    _flash_check(dev, q, k, v, torch.as_tensor(qp, dtype=torch.int32).to(dev),
                 torch.as_tensor(kp, dtype=torch.int32).to(dev), window,
                 dtype, tensor_cores=fa_ops.uses_tensor_cores(dtype, Dh))


@pytest.mark.parametrize("H,Hkv,Dh", [(16, 8, 128), (10, 1, 256),
                                      (4, 2, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_tile_mixing_rows_with_and_without_a_valid_key(dev, H, Hkv,
                                                             Dh, dtype):
    """Rows 3 and 40 of the first query tile have no valid key (position
    -1 under causal) among rows that have: they must average V over all
    Skv keys, while a window makes the early KV tiles skippable for the
    others."""
    B, Sq, Skv = 1, 130, 300
    q, k, v, _ = _flash_case(dev, B, Sq, Skv, H, Hkv, Dh, dtype, 32)
    qp = torch.arange(Skv - Sq, Skv, dtype=torch.int32,
                      device=dev).expand(B, Sq).contiguous()
    qp[0, 3] = -1
    qp[0, 40] = -1
    kp = torch.arange(Skv, dtype=torch.int32, device=dev).expand(
        B, Skv).contiguous()
    out = _flash_check(dev, q, k, v, qp, kp, 48, dtype,
                       tensor_cores=fa_ops.uses_tensor_cores(dtype, Dh))
    mean_v = v[0].float().mean(dim=0).repeat_interleave(H // Hkv, dim=0)
    tol = _tol(dtype)
    for row in (3, 40):
        torch.testing.assert_close(out[0, row].float(), mean_v, atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("Dh", [64, 128, 256])
def test_flash_window_skips_whole_tiles(dev, Dh):
    """A 64-key window over 700 keys: each query tile needs two or three
    KV tiles of eleven or more; the result must equal the plain version on
    every row (bf16, the tensor-core body)."""
    B, S, H, Hkv = 1, 700, 4, 2
    q, k, v, _ = _flash_case(dev, B, S, S, H, Hkv, Dh, torch.bfloat16, 33)
    pos = torch.arange(S, dtype=torch.int32, device=dev).expand(
        B, S).contiguous()
    _flash_check(dev, q, k, v, pos, pos, 64, torch.bfloat16,
                 tensor_cores=True)


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,Dh,window", [
    (1, 512, 544, 16, 8, 128, 0), (1, 384, 384, 10, 1, 256, 2048)])
def test_flash_main_shapes_take_the_tensor_cores(dev, B, Sq, Skv, H, Hkv,
                                                 Dh, window):
    """qwen3's chunk prefill and the hybrid's prefill, bf16."""
    q, k, v, _ = _flash_case(dev, B, Sq, Skv, H, Hkv, Dh, torch.bfloat16, 34)
    qp = torch.arange(Skv - Sq, Skv, dtype=torch.int32,
                      device=dev).expand(B, Sq).contiguous()
    kp = torch.arange(Skv, dtype=torch.int32, device=dev).expand(
        B, Skv).contiguous()
    _flash_check(dev, q, k, v, qp, kp, window, torch.bfloat16,
                 tensor_cores=True)


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


def _split_case(dev, B, n_pages, ps, H, Hkv, Dh, lens, q_dtype,
                pool_dtype, seed=23):
    """Rows of the given lengths over a shuffled pool whose table is
    ``n_pages`` wide; rows 0 and 1 alias their first two pages."""
    rng = np.random.default_rng(seed)
    P = B * n_pages + 4
    q = _t(rng.normal(size=(B, H, Dh)), q_dtype, dev)
    kp = _t(rng.normal(size=(P, ps, Hkv, Dh)), pool_dtype, dev)
    vp = _t(rng.normal(size=(P, ps, Hkv, Dh)), pool_dtype, dev)
    pt = np.asarray(rng.permutation(P)[:B * n_pages].reshape(B, n_pages),
                    np.int32)
    pt[1, :2] = pt[0, :2]
    k_new = _t(rng.normal(size=(B, Hkv, Dh)), pool_dtype, dev)
    v_new = _t(rng.normal(size=(B, Hkv, Dh)), pool_dtype, dev)
    return (q, kp, vp, torch.as_tensor(pt).to(dev),
            torch.as_tensor(np.asarray(lens, np.int32)).to(dev), k_new,
            v_new)


@pytest.mark.parametrize("ps,Dh", [(8, 128), (8, 16), (16, 64)])
@pytest.mark.parametrize("q_dtype,pool_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
def test_paged_split_single_blocked_fused_bitwise(dev, ps, Dh, q_dtype,
                                                  pool_dtype):
    """Chunks of several pages: the write slot on the first page of a
    chunk (row 0), on its last page (row 1), in a row shorter than one
    chunk (row 2), and a padding row; single == blocked == fused after
    the scatter, bit for bit, and each call is split."""
    cp = pd_ops.plan_chunk_pages(ps, Dh)
    n_pages = 3 * cp + 1
    lens = [cp * ps + 3, (2 * cp - 1) * ps + ps - 1, ps + 2, -1]
    q, kp, vp, pt, ln, k_new, v_new = _split_case(
        dev, 4, n_pages, ps, 4, 2, Dh, lens, q_dtype, pool_dtype)
    s0 = pd_ops.split_launches
    single, m, l = pd_ops.paged_decode_attention(
        q, kp, vp, pt, ln, variant="single", return_lse=True)
    ref, mr, lr = paged_decode_attention_ref(q, kp, vp, pt, ln,
                                             return_lse=True)
    tol = _tol(q_dtype)
    torch.testing.assert_close(single.float(), ref.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(m, mr, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(l, lr, atol=2e-5, rtol=2e-5)
    assert torch.all(single[-1] == 0)
    assert torch.all(m[-1] == NEG_INF) and torch.all(l[-1] == 0)
    for ppb in (2, 3, 4, 8):
        blocked = pd_ops.paged_decode_attention(
            q, kp, vp, pt, ln, variant="blocked", pages_per_block=ppb)
        assert torch.equal(blocked, single), ppb
        ks, vs = scatter_append_ref(kp.clone(), vp.clone(), pt, ln, k_new,
                                    v_new)
        base, mb, lb = pd_ops.paged_decode_attention(
            q, ks, vs, pt, ln, variant="single", return_lse=True)
        kf, vf = kp.clone(), vp.clone()
        fused, mf, lf, _, _ = pd_ops.fused_paged_decode_attention(
            q, kf, vf, pt, ln, k_new, v_new, pages_per_block=ppb,
            return_lse=True)
        assert torch.equal(fused, base) and torch.equal(mf, mb) \
            and torch.equal(lf, lb), ppb
        assert torch.equal(kf, ks) and torch.equal(vf, vs), ppb
    torch.cuda.synchronize()
    assert pd_ops.split_launches - s0 == 1 + 4 * 3


@pytest.mark.parametrize("q_dtype,pool_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("variant", ["single", "blocked"])
def test_paged_row_is_bitwise_equal_alone_and_in_a_batch(dev, q_dtype,
                                                         pool_dtype,
                                                         variant):
    """The chunk plan ignores B and the table's width: each row of a
    batch of eight under a table wider than every row gives the bits of
    the same row alone under its own table."""
    ps, Dh = 8, 128
    cp = pd_ops.plan_chunk_pages(ps, Dh)
    lens = [65 * ps - 3, 2, cp * ps, cp * ps - 1, 3 * cp * ps + 5, -1,
            20 * ps + 1, 40 * ps + 7]
    q, kp, vp, pt, ln, _, _ = _split_case(
        dev, 8, 70, ps, 16, 8, Dh, lens, q_dtype, pool_dtype, seed=29)
    out, m, l = pd_ops.paged_decode_attention(
        q, kp, vp, pt, ln, variant=variant, return_lse=True)
    for i, n in enumerate(lens):
        own = max(1, n // ps + 1)
        o1, m1, l1 = pd_ops.paged_decode_attention(
            q[i:i + 1].contiguous(), kp, vp, pt[i:i + 1, :own].contiguous(),
            ln[i:i + 1].contiguous(), variant=variant, return_lse=True)
        assert torch.equal(o1[0], out[i]), i
        assert torch.equal(m1[0], m[i]) and torch.equal(l1[0], l[i]), i


@pytest.mark.parametrize("n_pages", [5, 20, 70])
def test_paged_split_padding_row_writes_nothing(dev, n_pages):
    """A padding row's blocks, split or not, write nothing and its output
    is pinned; its neighbours' appends land."""
    lens = [n_pages * 8 - 9, -1, 11]
    q, kp, vp, pt, ln, _, _ = _split_case(
        dev, 3, n_pages, 8, 4, 2, 16, lens, torch.float32, torch.float32)
    k_new = torch.full((3, 2, 16), 1e6, device=dev)
    v_new = torch.full((3, 2, 16), -1e6, device=dev)
    ks, vs = scatter_append_ref(kp.clone(), vp.clone(), pt, ln, k_new,
                                v_new)
    out, m, l, k_out, v_out = pd_ops.fused_paged_decode_attention(
        q, kp, vp, pt, ln, k_new, v_new, return_lse=True)
    assert torch.equal(k_out, ks) and torch.equal(v_out, vs)
    assert int((k_out == 1e6).sum()) == 2 * 2 * 16
    for pg in pt[1].tolist():
        if pg not in pt[0].tolist() + pt[2].tolist():
            assert not torch.any(k_out[pg] == 1e6)
            assert not torch.any(v_out[pg] == -1e6)
    assert torch.all(out[1] == 0)
    assert torch.all(m[1] == NEG_INF) and torch.all(l[1] == 0)


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


@pytest.mark.parametrize("T,H,Hkv,Dh", [
    (40, 4, 2, 64), (100, 16, 8, 128), (517, 10, 1, 256),
    (5000, 10, 1, 256), (1000, 2, 2, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_split_chunks_match_plain(dev, T, H, Hkv, Dh, dtype):
    """One chunk (T=40), T no multiple of the chunk, many chunks of one
    sub-tile and (T=5000) chunks of several; a run of empty slots spans
    whole chunks of row 1."""
    B = 3
    q, k, v, qp, kp = _ring_case(dev, B, T, H, Hkv, Dh, dtype)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    chunk, n_chunks = da_ops.plan_chunks(T, Dh, n_sm)
    kp[1, chunk // 2:chunk // 2 + 3 * chunk] = -1
    n0, s0 = da_ops.launches, da_ops.split_launches
    out, m, l = da_ops.decode_attention(q, k, v, q_positions=qp,
                                        kv_positions=kp, return_lse=True)
    torch.cuda.synchronize()
    assert da_ops.launches == n0 + 1
    assert da_ops.split_launches == s0 + (n_chunks > 1)
    ref, mr, lr = decode_attention_ref(q, k, v, q_positions=qp,
                                       kv_positions=kp, return_lse=True)
    tol = _tol(dtype)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(m, mr, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(l, lr, atol=2e-5, rtol=2e-5)
    assert torch.all(out[-1] == 0)
    assert torch.all(m[-1] == NEG_INF) and torch.all(l[-1] == 0)


@pytest.mark.parametrize("T,H,Hkv,Dh", [(512, 10, 1, 256),
                                        (300, 16, 8, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_row_is_bitwise_equal_alone_and_in_a_batch(dev, T, H, Hkv,
                                                          Dh, dtype):
    """The chunk plan ignores B: row 2 of a batch of eight gives the same
    bits as the same row alone."""
    q, k, v, qp, kp = _ring_case(dev, 8, T, H, Hkv, Dh, dtype, seed=8)
    out, m, l = da_ops.decode_attention(q, k, v, q_positions=qp,
                                        kv_positions=kp, window=200,
                                        return_lse=True)
    one = [x[2:3].contiguous() for x in (q, k, v, qp, kp)]
    out1, m1, l1 = da_ops.decode_attention(
        one[0], one[1], one[2], q_positions=one[3], kv_positions=one[4],
        window=200, return_lse=True)
    assert torch.equal(out1[0], out[2])
    assert torch.equal(m1[0], m[2]) and torch.equal(l1[0], l[2])


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


@pytest.mark.parametrize("B,S,D", [(2, 100, 40), (3, 129, 70), (1, 1, 2560),
                                   (4, 1, 33), (2, 200, 2560), (1, 64, 16)])
def test_scan_past_tile_and_block_edges_equals_plain_bitwise(dev, B, S, D):
    """S not a multiple of the 64-step tile, D not a multiple of a block's
    32 channels (16-byte copies at D = 40 and 16, 4-byte ones at 70 and
    33), B > 1 and S = 1."""
    rng = np.random.default_rng(B * S + D)
    a = torch.as_tensor(rng.uniform(0.5, 1.0, size=(B, S, D)),
                        dtype=torch.float32).to(dev)
    b = torch.as_tensor(rng.normal(size=(B, S, D)),
                        dtype=torch.float32).to(dev)
    assert torch.equal(lru_ops.linear_scan(a, b), linear_scan_ref(a, b))


def _prefix_case(dev, B, H, Hkv, Dh, P, Ts, dtype, seed=21):
    """The shared prefix and ragged suffixes: row 0 sees its whole suffix,
    the last-but-one row's suffix is all -1 and the last row's query sits
    before the prefix's end (its suffix is masked)."""
    rng = np.random.default_rng(seed)
    q = _t(rng.normal(size=(B, H, Dh)), dtype, dev)
    pk = _t(rng.normal(size=(P, Hkv, Dh)), dtype, dev)
    pv = _t(rng.normal(size=(P, Hkv, Dh)), dtype, dev)
    sk = _t(rng.normal(size=(B, Ts, Hkv, Dh)), dtype, dev)
    sv = _t(rng.normal(size=(B, Ts, Hkv, Dh)), dtype, dev)
    lens = rng.integers(1, Ts + 1, size=(B,))
    lens[0] = Ts
    qp = P + lens - 1
    lens[-2] = 0
    qp[-1] = P // 3
    sp = np.where(np.arange(Ts)[None, :] < lens[:, None],
                  P + np.arange(Ts)[None, :], -1)
    return (q, pk, pv, sk, sv,
            torch.as_tensor(qp, dtype=torch.int32).to(dev),
            torch.as_tensor(sp, dtype=torch.int32).to(dev))


@pytest.mark.parametrize("B,H,Hkv,Dh", [
    (4, 16, 8, 128), (3, 10, 1, 256), (5, 4, 2, 64), (64, 16, 8, 128),
    (8, 16, 1, 64)])
@pytest.mark.parametrize("P", [37, 131, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefix_kernel_matches_plain(dev, B, H, Hkv, Dh, P, dtype):
    """The sweep's shapes, P prime and not a multiple of any tile, and
    B*G = 128 query rows per KV head (B=64, G=2 and B=8, G=16)."""
    q, pk, pv, *_ = _prefix_case(dev, B, H, Hkv, Dh, P, 4, dtype)
    pos = torch.arange(P, dtype=torch.int32, device=dev)
    pos[::7] = -1                               # masked prefix slots
    n0 = sp_ops.launches
    acc, m, l = sp_ops.prefix_attention(q, pk, pv, pos)
    torch.cuda.synchronize()
    assert sp_ops.launches == n0 + 1
    ra, rm, rl = prefix_attention_ref(q, pk, pv, pos)
    # the kernel sums in f32 in another order: acc is unnormalized
    torch.testing.assert_close(acc, ra, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(m, rm, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(l, rl, atol=2e-5, rtol=2e-5)


def test_prefix_kernel_with_no_valid_key_is_pinned(dev):
    q, pk, pv, *_ = _prefix_case(dev, 3, 16, 8, 128, 200, 4, torch.float32)
    acc, m, l = sp_ops.prefix_attention(
        q, pk, pv, torch.full((200,), -1, dtype=torch.int32, device=dev))
    assert torch.all(acc == 0) and torch.all(l == 0)
    assert torch.all(m == NEG_INF)


@pytest.mark.parametrize("H,Hkv,Dh", [(16, 8, 128), (10, 1, 256),
                                      (4, 2, 64)])
@pytest.mark.parametrize("P", [37, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shared_prefix_op_matches_plain(dev, H, Hkv, Dh, P, dtype):
    q, pk, pv, sk, sv, qp, sp = _prefix_case(dev, 5, H, Hkv, Dh, P, 70,
                                             dtype)
    n0, d0 = sp_ops.launches, da_ops.launches
    out = sp_ops.shared_prefix_attention(q, pk, pv, sk, sv, q_positions=qp,
                                         suffix_positions=sp)
    torch.cuda.synchronize()
    assert (sp_ops.launches, da_ops.launches) == (n0 + 1, d0 + 1)
    ref = shared_prefix_attention_ref(q, pk, pv, sk, sv, q_positions=qp,
                                      suffix_positions=sp)
    # bf16: the op's f32 values may round to bf16 the other way (read at
    # most 2.4e-4 on an H100), so 2e-3 plus one bf16 ulp
    tol = {"atol": 2e-5, "rtol": 2e-5} if dtype == torch.float32 \
        else {"atol": 2e-3, "rtol": 8e-3}
    torch.testing.assert_close(out.float(), ref.float(), **tol)


@pytest.mark.parametrize("Dh", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefix_kernel_body_by_dtype(dev, Dh, dtype):
    """Every bf16 launch takes the tensor-core body, every f32 launch the
    CUDA-core body; the op's prefix launch counts the same way."""
    q, pk, pv, sk, sv, qp, sp = _prefix_case(dev, 4, 8, 2, Dh, 300, 40,
                                             dtype)
    before = (sp_ops.tensor_core_launches, sp_ops.cuda_core_launches)
    sp_ops.prefix_attention(q, pk, pv,
                            torch.arange(300, dtype=torch.int32, device=dev))
    sp_ops.shared_prefix_attention(q, pk, pv, sk, sv, q_positions=qp,
                                   suffix_positions=sp)
    torch.cuda.synchronize()
    tc = int(sp_ops.uses_tensor_cores(dtype))
    assert (sp_ops.tensor_core_launches - before[0],
            sp_ops.cuda_core_launches - before[1]) == (2 * tc, 2 - 2 * tc)


@pytest.mark.parametrize("H,Hkv,Dh", [(16, 8, 128), (10, 1, 256),
                                      (16, 1, 64)])
@pytest.mark.parametrize("P", [131, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefix_row_is_bitwise_equal_alone_and_in_a_batch(dev, H, Hkv, Dh,
                                                          P, dtype):
    """The chunk plan ignores B and mma rows are independent: row 2 of a
    batch of eight gives the same (acc, m, l) and op output bits as the
    same row alone (at G=16 the batch spans two row tiles of 64)."""
    q, pk, pv, sk, sv, qp, sp = _prefix_case(dev, 8, H, Hkv, Dh, P, 70,
                                             dtype, seed=5)
    pos = torch.arange(P, dtype=torch.int32, device=dev)
    pos[::5] = -1
    acc, m, l = sp_ops.prefix_attention(q, pk, pv, pos)
    out = sp_ops.shared_prefix_attention(q, pk, pv, sk, sv, q_positions=qp,
                                         suffix_positions=sp)
    one = [x[2:3].contiguous() for x in (q, sk, sv, qp, sp)]
    acc1, m1, l1 = sp_ops.prefix_attention(one[0], pk, pv, pos)
    out1 = sp_ops.shared_prefix_attention(one[0], pk, pv, one[1], one[2],
                                          q_positions=one[3],
                                          suffix_positions=one[4])
    assert torch.equal(acc1[0], acc[2])
    assert torch.equal(m1[0], m[2]) and torch.equal(l1[0], l[2])
    assert torch.equal(out1[0], out[2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shared_prefix_op_is_two_kernels_and_never_the_plain_merge(
        dev, dtype, monkeypatch):
    """On the card the op is the decode-attention launch over the suffix
    and one prefix launch that merges the two; the plain merge never
    runs."""
    def plain_merge(*args, **kwargs):
        raise AssertionError("the plain merge ran on CUDA tensors")

    monkeypatch.setattr(sp_ops, "merge_prefix_suffix", plain_merge)
    q, pk, pv, sk, sv, qp, sp = _prefix_case(dev, 8, 16, 8, 128, 2048, 512,
                                             dtype)
    n0, d0 = sp_ops.launches, da_ops.launches
    out = sp_ops.shared_prefix_attention(q, pk, pv, sk, sv, q_positions=qp,
                                         suffix_positions=sp)
    torch.cuda.synchronize()
    assert (sp_ops.launches, da_ops.launches) == (n0 + 1, d0 + 1)
    ref = shared_prefix_attention_ref(q, pk, pv, sk, sv, q_positions=qp,
                                      suffix_positions=sp)
    tol = {"atol": 2e-5, "rtol": 2e-5} if dtype == torch.float32 \
        else {"atol": 2e-3, "rtol": 8e-3}
    torch.testing.assert_close(out.float(), ref.float(), **tol)


def test_prefix_kernel_refuses_what_it_cannot_take(dev):
    q, pk, pv, *_ = _prefix_case(dev, 3, 8, 8, 32, 40, 4, torch.float32)
    pos = torch.arange(40, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        sp_ops.prefix_attention(q, pk, pv, pos)
    q, pk, pv, *_ = _prefix_case(dev, 3, 34, 2, 64, 40, 4, torch.float32)
    with pytest.raises(ValueError, match="query heads"):
        sp_ops.prefix_attention(q, pk, pv, pos)


# ---------------------------------------------------- the backward kernels

def _bwd_close(got, ref, dtype):
    g, r = got.float(), ref.float()
    if dtype == torch.float32:
        scale = max(float(r.abs().max()), 1e-6)
        assert float((g - r).abs().max()) <= 1e-4 * scale
        return
    assert bool(((g - r).abs() <= 2e-3 + 8e-3 * r.abs()).all()), \
        float(((g - r).abs() / (2e-3 + 8e-3 * r.abs())).max())
    rms = lambda x: float(x.pow(2).mean().sqrt())  # noqa: E731
    assert rms(g - r) <= 0.05 * rms(r)


def _flash_bwd_case(dev, B, Sq, Skv, H, Hkv, Dh, dtype, seed):
    rng = np.random.default_rng(seed)
    q = _t(rng.normal(size=(B, Sq, H, Dh)), dtype, dev).requires_grad_()
    k = _t(rng.normal(size=(B, Skv, Hkv, Dh)), dtype, dev).requires_grad_()
    v = _t(rng.normal(size=(B, Skv, Hkv, Dh)), dtype, dev).requires_grad_()
    do = _t(rng.normal(size=(B, Sq, H, Dh)), dtype, dev)
    qp = torch.arange(Skv - Sq, Skv, dtype=torch.int32,
                      device=dev).expand(B, Sq).contiguous()
    kp = torch.arange(Skv, dtype=torch.int32, device=dev).expand(
        B, Skv).contiguous()
    qp[0, 0] = -1                  # a row with no valid key: mean(V)
    kp[B - 1, 3] = -1              # an invalid slot
    return q, k, v, do, qp, kp


@pytest.mark.parametrize("Dh", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 5, 10])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_matches_plain(dev, Dh, G, dtype):
    """dQ, dK, dV through the autograd Function (the forward kernel with
    its log-sum-exp, then the backward kernel) against the plain backward,
    causal, with a window at Dh 256, over 70 queries and 90 keys (ragged
    tiles), a row with no valid key and an invalid key slot."""
    Hkv = 2
    window = 24 if Dh == 256 else 0
    q, k, v, do, qp, kp = _flash_bwd_case(dev, 2, 70, 90, G * Hkv, Hkv, Dh,
                                          dtype, seed=Dh + G)
    n0, b0 = fa_ops.launches, fa_ops.bwd_launches
    t0 = fa_ops.bwd_tensor_core_launches
    out = fa_ops.flash_attention(q, k, v, q_positions=qp, kv_positions=kp,
                                 causal=True, window=window)
    out.backward(do)
    torch.cuda.synchronize()
    assert (fa_ops.launches, fa_ops.bwd_launches) == (n0 + 1, b0 + 1)
    tc = dtype == torch.bfloat16 and Dh in (64, 128, 256)
    assert fa_ops.bwd_tensor_core_launches == t0 + int(tc)
    refs = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), do,
                                   q_positions=qp, kv_positions=kp,
                                   causal=True, window=window)
    for got, ref in zip((q.grad, k.grad, v.grad), refs):
        assert got.dtype == dtype
        _bwd_close(got, ref, dtype)


@pytest.mark.parametrize("Dh", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_non_causal_matches_plain(dev, Dh, dtype):
    """Whisper's encoder and cross-attention: non-causal, keys past the
    queries, the cross keys' tail invalid."""
    q, k, v, do, qp, kp = _flash_bwd_case(dev, 2, 40, 100, 6, 6, Dh, dtype,
                                          seed=Dh)
    qp = torch.arange(40, dtype=torch.int32, device=dev).expand(
        2, 40).contiguous()
    kp[:, 80:] = -1
    out = fa_ops.flash_attention(q, k, v, q_positions=qp, kv_positions=kp,
                                 causal=False)
    out.backward(do)
    refs = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), do,
                                   q_positions=qp, kv_positions=kp,
                                   causal=False)
    for got, ref in zip((q.grad, k.grad, v.grad), refs):
        _bwd_close(got, ref, dtype)


@pytest.mark.parametrize("B,S,H,Hkv,Dh,window", [
    (1, 200, 10, 1, 256, 0), (2, 130, 16, 8, 128, 0), (2, 150, 6, 6, 64, 0),
    (1, 200, 10, 1, 256, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_is_deterministic(dev, B, S, H, Hkv, Dh, window,
                                         dtype):
    """Two calls on the same inputs give the same bits: every output is
    written by one block, and the split heads' partial dK and dV (here
    every one of the hybrid's 10 heads its own block) are summed in split
    order."""
    q, k, v, do, qp, kp = _flash_bwd_case(dev, B, S, S, H, Hkv, Dh, dtype,
                                          seed=S + Dh)
    kw = dict(q_positions=qp, kv_positions=kp, causal=True, window=window)
    _, lse = fa_ops.flash_attention_lse(q.detach(), k.detach(), v.detach(),
                                        **kw)
    if Hkv == 1:                    # the hybrid's: the split heads' sum runs
        assert fa_ops.bwd_head_split(B, S, Hkv, H // Hkv,
                                     torch.cuda.get_device_properties(
                                         dev).multi_processor_count) > 1
    first = fa_ops.flash_attention_bwd(q.detach(), k.detach(), v.detach(), do,
                                       lse, **kw)
    second = fa_ops.flash_attention_bwd(q.detach(), k.detach(), v.detach(),
                                        do, lse, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_backward_refuses_a_head_dim_before_the_forward(dev):
    q = torch.zeros(1, 8, 2, 32, device=dev, requires_grad=True)
    kv = torch.zeros(1, 8, 2, 32, device=dev)
    pos = torch.arange(8, dtype=torch.int32, device=dev)[None]
    n0 = fa_ops.launches
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.flash_attention(q, kv, kv, q_positions=pos, kv_positions=pos)
    assert fa_ops.launches == n0


@pytest.mark.parametrize("B,S,D", [(2, 37, 70), (3, 129, 16), (1, 1, 33),
                                   (4, 512, 2560)])
def test_scan_backward_equals_plain_bitwise(dev, B, S, D):
    """The backward kernel walks time backwards and rounds as the plain
    reverse walk: da and db equal the plain backward bit for bit."""
    rng = np.random.default_rng(B + S + D)
    a = torch.as_tensor(rng.uniform(0.5, 1.0, size=(B, S, D)),
                        dtype=torch.float32).to(dev).requires_grad_()
    b = torch.as_tensor(rng.normal(size=(B, S, D)),
                        dtype=torch.float32).to(dev).requires_grad_()
    dh = torch.as_tensor(rng.normal(size=(B, S, D)),
                         dtype=torch.float32).to(dev)
    n0, b0 = lru_ops.launches, lru_ops.bwd_launches
    h = lru_ops.linear_scan(a, b)
    h.backward(dh)
    torch.cuda.synchronize()
    assert (lru_ops.launches, lru_ops.bwd_launches) == (n0 + 1, b0 + 1)
    da, db = linear_scan_bwd_ref(a.detach(), h.detach(), dh)
    assert torch.equal(a.grad, da) and torch.equal(b.grad, db)


def test_scan_backward_is_one_kernel_with_no_copies(dev, tmp_path):
    """One call of the scan's backward is one launch of one kernel: no
    flip, cat or elementwise pass around it, in a CUDA graph captured from
    a call (its nodes listed from the graph's DOT dump) and, where the
    profiler reports device events, in the profiler's trace."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(5)
    a, h, dh = (torch.as_tensor(rng.normal(size=(2, 300, 96)),
                                dtype=torch.float32).to(dev)
                for _ in range(3))
    lru_ops.linear_scan_bwd(a, h, dh)
    torch.cuda.synchronize()
    b0 = lru_ops.bwd_launches
    # kept, not instantiated: the dump reads the captured graph
    g = torch.cuda.CUDAGraph(keep_graph=True)
    g.enable_debug_mode()
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        lru_ops.linear_scan_bwd(a, h, dh)
    g.debug_dump(str(tmp_path / "graph.dot"))
    dot = (tmp_path / "graph.dot").read_text()
    nodes = re.split(r'^"graph_\d+_node_\d+"\s*\[', dot, flags=re.M)[1:]
    assert len(nodes) == 1 and "linear_scan_bwd_kernel" in nodes[0], dot
    assert lru_ops.bwd_launches == b0 + 1
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lru_ops.linear_scan_bwd(a, h, dh)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert lru_ops.bwd_launches == b0 + 2
    assert not names or (len(names) == 1
                         and "linear_scan_bwd_kernel" in names[0]), names
