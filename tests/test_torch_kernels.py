"""The port's plain kernel versions against the JAX package's, on the CPU.

Mirrors the sweeps of ``tests/test_kernels.py``: the same inputs, made
from a numpy seed, go through the JAX reference (or the Pallas kernel in
interpret mode) and through the port's wrapper, which on CPU tensors
runs the plain version and launches nothing.  Tolerances: f32 2e-5 (the
two frameworks sum in different orders), bf16 3e-2 (one bf16 rounding
of the output or of the probs may land on the other side), bitwise for
the pool contents, which are copied, never computed.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import common as jcommon  # noqa: E402
from repro.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention as j_decode)
from repro.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref as j_decode_ref, lse_combine as j_lse_combine)
from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention as j_flash)
from repro.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref as j_flash_ref)
from repro.kernels.paged_decode_attention.ops import (  # noqa: E402
    fused_paged_decode_attention as j_fused,
    paged_decode_attention as j_paged)
from repro.kernels.paged_decode_attention.ref import (  # noqa: E402
    fused_paged_decode_attention_ref as j_fused_ref,
    paged_decode_attention_ref as j_paged_ref)
from repro.kernels.rglru_scan.ops import (  # noqa: E402
    linear_scan as j_linear_scan)
from repro.kernels.rglru_scan.ref import (  # noqa: E402
    linear_scan_ref as j_linear_scan_ref)
from repro.kernels.shared_prefix_attention.kernel import (  # noqa: E402
    prefix_attention_kernel as j_prefix_kernel)
from repro.kernels.shared_prefix_attention.ops import (  # noqa: E402
    shared_prefix_attention as j_shared_prefix)
from repro.kernels.shared_prefix_attention.ref import (  # noqa: E402
    shared_prefix_attention_ref as j_shared_prefix_ref)
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.common import NEG_INF  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import lse_combine  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.paged_decode_attention import (  # noqa: E402
    ops as pd_ops)
from repro_torch.kernels.rglru_scan import ops as lru_ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import linear_scan_ref  # noqa: E402
from repro_torch.kernels.shared_prefix_attention import (  # noqa: E402
    ops as sp_ops)
from repro_torch.kernels.shared_prefix_attention.ref import (  # noqa: E402
    merge_prefix_suffix, prefix_attention_ref)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU shapes gain nothing from torch's thread pool, and its
    spinning threads would slow the tests other workers run meanwhile."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RNG = np.random.default_rng(7)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dtype):
    """The same values as a JAX array and a torch tensor."""
    jd, td = DTYPES[dtype]
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, jd), torch.from_numpy(a.copy()).to(td)


def _ints(a):
    a = np.asarray(a, np.int32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _close(t_out, j_out, tol, exact=False):
    a = t_out.float().numpy()
    b = np.asarray(j_out, np.float32)
    if exact:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


def _tol(dtype):
    return 2e-5 if dtype == "float32" else 3e-2


# ---------------------------------------------------------------- flash

def _flash_inputs(B, Sq, Skv, H, Hkv, Dh, dtype):
    q = _pair(RNG.normal(size=(B, Sq, H, Dh)), dtype)
    k = _pair(RNG.normal(size=(B, Skv, Hkv, Dh)), dtype)
    v = _pair(RNG.normal(size=(B, Skv, Hkv, Dh)), dtype)
    qp = _ints(np.broadcast_to(np.arange(Skv - Sq, Skv), (B, Sq)))
    kp = _ints(np.broadcast_to(np.arange(Skv), (B, Skv)))
    return q, k, v, qp, kp


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,Dh", [
    (1, 32, 32, 2, 2, 8), (2, 64, 64, 4, 2, 16), (2, 16, 64, 8, 1, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 24])
def test_flash_sweep_matches_jax_ref(B, Sq, Skv, H, Hkv, Dh, dtype, window):
    q, k, v, qp, kp = _flash_inputs(B, Sq, Skv, H, Hkv, Dh, dtype)
    out = fa_ops.flash_attention(q[1], k[1], v[1], q_positions=qp[1],
                                 kv_positions=kp[1], window=window)
    ref = j_flash_ref(q[0], k[0], v[0], q_positions=qp[0],
                      kv_positions=kp[0], causal=True, window=window)
    assert out.dtype == q[1].dtype
    _close(out, ref, _tol(dtype))


def test_flash_matches_pallas_interpret_and_no_valid_key_gives_mean_v():
    q, k, v, qp, kp = _flash_inputs(2, 32, 48, 4, 2, 16, "float32")
    qp_np = np.array(qp[1].numpy())
    qp_np[1, :3] = -1                         # rows with no valid key
    qp = _ints(qp_np)
    out = fa_ops.flash_attention(q[1], k[1], v[1], q_positions=qp[1],
                                 kv_positions=kp[1], window=8)
    pallas = j_flash(q[0], k[0], v[0], q_positions=qp[0],
                     kv_positions=kp[0], causal=True, window=8, block_q=16,
                     block_kv=16, interpret=True)
    _close(out, pallas, 2e-5)
    mean_v = v[1][1].mean(dim=0).repeat_interleave(2, dim=0)   # (H, Dh)
    for row in range(3):
        torch.testing.assert_close(out[1, row], mean_v, atol=2e-5,
                                   rtol=2e-5)


def test_wrappers_take_the_plain_path_on_cpu_and_count_nothing():
    q, k, v, qp, kp = _flash_inputs(1, 16, 16, 2, 2, 8, "float32")
    n_fa, n_pd = fa_ops.launches, pd_ops.launches
    fa_ops.flash_attention(q[1], k[1], v[1], q_positions=qp[1],
                           kv_positions=kp[1])
    qd, kpool, vpool, pt, lens = _paged_case()
    pd_ops.paged_decode_attention(qd[1], kpool[1], vpool[1], pt[1], lens[1])
    kn, vn = _new_kv(3, 2, 16, "float32")
    pd_ops.fused_paged_decode_attention(qd[1], kpool[1], vpool[1], pt[1],
                                        lens[1], kn[1], vn[1])
    qr, kr, vr, qpr, kpr = _ring_inputs(3, 16, 2, 1, 32, "float32")
    n_da, n_lru = da_ops.launches, lru_ops.launches
    da_ops.decode_attention(qr[1], kr[1], vr[1], q_positions=qpr[1],
                            kv_positions=kpr[1])
    lru_ops.linear_scan(torch.ones(1, 3, 4), torch.ones(1, 3, 4))
    n_sp = sp_ops.launches
    n_body = (sp_ops.tensor_core_launches, sp_ops.cuda_core_launches)
    (qs, pk, pv, sk, sv), qps, sps = _prefix_case(2, 4, 2, 16, 37, 8,
                                                  "float32")
    sp_ops.prefix_attention(qs[1], pk[1], pv[1],
                            torch.arange(37, dtype=torch.int32))
    sp_ops.shared_prefix_attention(qs[1], pk[1], pv[1], sk[1], sv[1],
                                   q_positions=qps[1],
                                   suffix_positions=sps[1])
    assert (fa_ops.launches, pd_ops.launches) == (n_fa, n_pd)
    assert (da_ops.launches, lru_ops.launches) == (n_da, n_lru)
    assert sp_ops.launches == n_sp
    assert (sp_ops.tensor_core_launches, sp_ops.cuda_core_launches) == n_body
    with pytest.raises(TypeError):
        sp_ops.prefix_attention(qs[1], pk[1], pv[1],
                                torch.arange(37, dtype=torch.int64))
    with pytest.raises(TypeError):
        sp_ops.prefix_attention(qs[1], pk[1].double(), pv[1],
                                torch.arange(37, dtype=torch.int32))
    with pytest.raises(TypeError):
        lru_ops.linear_scan(torch.ones(1, 3, 4, dtype=torch.bfloat16),
                            torch.ones(1, 3, 4, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q[1], k[1], v[1], q_positions=qp[1].long(),
                               kv_positions=kp[1])
    with pytest.raises(ValueError):
        pd_ops.paged_decode_attention(qd[1], kpool[1], vpool[1], pt[1],
                                      lens[1], variant="nope")


# ---------------------------------------------------------- paged decode

def _paged_case(B=3, NP=5, ps=8, H=4, Hkv=2, Dh=16, seed=11,
                dtype="float32"):
    """Shuffled pool, lengths ending mid-page, rows 0/1 aliasing their
    first two pages, one padding row (tests/test_kernels.py:141)."""
    rng = np.random.default_rng(seed)
    P = 2 * B * NP
    q = _pair(rng.normal(size=(B, H, Dh)), dtype)
    kp = _pair(rng.normal(size=(P, ps, Hkv, Dh)), dtype)
    vp = _pair(rng.normal(size=(P, ps, Hkv, Dh)), dtype)
    pt = np.asarray(rng.permutation(P)[:B * NP].reshape(B, NP), np.int32)
    pt[1, :2] = pt[0, :2]
    lens = np.asarray(rng.integers(2 * ps + 1, NP * ps - 2, size=(B,)),
                      np.int32)
    lens = np.where(lens % ps == 0, lens + 1, lens)
    lens[-1] = -1
    return q, kp, vp, _ints(pt), _ints(lens)


def _new_kv(B, Hkv, Dh, dtype, seed=99):
    rng = np.random.default_rng(seed)
    return (_pair(rng.normal(size=(B, Hkv, Dh)), dtype),
            _pair(rng.normal(size=(B, Hkv, Dh)), dtype))


@pytest.mark.parametrize("B,NP,ps,H,Hkv,Dh", [
    (2, 4, 8, 4, 2, 16), (1, 3, 16, 8, 8, 8), (3, 5, 8, 6, 1, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_sweep_matches_jax_ref(B, NP, ps, H, Hkv, Dh, dtype):
    """Shuffled pool, every row ending mid-page, one padded row when the
    batch allows (tests/test_kernels.py:89)."""
    P = 2 * B * NP
    q = _pair(RNG.normal(size=(B, H, Dh)), dtype)
    kp = _pair(RNG.normal(size=(P, ps, Hkv, Dh)), dtype)
    vp = _pair(RNG.normal(size=(P, ps, Hkv, Dh)), dtype)
    pt = _ints(RNG.permutation(P)[:B * NP].reshape(B, NP))
    lens = np.asarray(RNG.integers((NP - 1) * ps, NP * ps - 1, size=(B,)),
                      np.int32)
    lens = np.where(lens % ps == 0, lens + 1, lens)
    if B > 1:
        lens[-1] = -1
    lens = _ints(lens)
    for variant in ("single", "blocked"):
        out = pd_ops.paged_decode_attention(q[1], kp[1], vp[1], pt[1],
                                            lens[1], variant=variant)
        ref = j_paged_ref(q[0], kp[0], vp[0], pt[0], lens[0])
        _close(out, ref, _tol(dtype))


def test_paged_aliased_pages_and_lse_match_jax():
    B, NP, ps, H, Hkv, Dh, P = 2, 3, 8, 4, 2, 16, 8
    q = _pair(RNG.normal(size=(B, H, Dh)), "float32")
    kp = _pair(RNG.normal(size=(P, ps, Hkv, Dh)), "float32")
    vp = _pair(RNG.normal(size=(P, ps, Hkv, Dh)), "float32")
    pt = _ints([[0, 1, 2], [0, 1, 4]])
    lens = _ints([ps * 2 + 3, ps * 2 + 5])
    out, m, l = pd_ops.paged_decode_attention(q[1], kp[1], vp[1], pt[1],
                                              lens[1], return_lse=True)
    ref, mr, lr = j_paged_ref(q[0], kp[0], vp[0], pt[0], lens[0],
                              return_lse=True)
    for a, b in ((out, ref), (m, mr), (l, lr)):
        _close(a, b, 2e-5)


def test_paged_matches_pallas_single_in_interpret_mode():
    q, kp, vp, pt, lens = _paged_case()
    out, m, l = pd_ops.paged_decode_attention(
        q[1], kp[1], vp[1], pt[1], lens[1], variant="single",
        return_lse=True)
    jo, jm, jl = j_paged(q[0], kp[0], vp[0], pt[0], lens[0],
                         variant="single", return_lse=True, interpret=True)
    for a, b in ((out, jo), (m, jm), (l, jl)):
        _close(a, b, 2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_matches_jax_ref_outputs_and_pools(dtype):
    """Fused append+attend against the JAX scatter-then-attend oracle: the
    outputs, the (m, l) state and the pool contents afterwards."""
    q, kp, vp, pt, lens = _paged_case(seed=13, dtype=dtype)
    kn, vn = _new_kv(3, 2, 16, dtype)
    jo, jm, jl, jk, jv = j_fused_ref(q[0], kp[0], vp[0], pt[0], lens[0],
                                     kn[0], vn[0], return_lse=True)
    k_pool, v_pool = kp[1].clone(), vp[1].clone()
    out, m, l, k_out, v_out = pd_ops.fused_paged_decode_attention(
        q[1], k_pool, v_pool, pt[1], lens[1], kn[1], vn[1],
        return_lse=True)
    assert k_out is k_pool and v_out is v_pool          # in place
    _close(out, jo, _tol(dtype))
    _close(m, jm, 2e-5)
    _close(l, jl, 2e-5)
    _close(k_out, jk, 0, exact=True)
    _close(v_out, jv, 0, exact=True)


def test_fused_matches_pallas_fused_in_interpret_mode():
    q, kp, vp, pt, lens = _paged_case(seed=13)
    kn, vn = _new_kv(3, 2, 16, "float32")
    jo, jk, jv = j_fused(q[0], kp[0], vp[0], pt[0], lens[0], kn[0], vn[0],
                         pages_per_block=2, interpret=True)
    out, k_out, v_out = pd_ops.fused_paged_decode_attention(
        q[1], kp[1].clone(), vp[1].clone(), pt[1], lens[1], kn[1], vn[1])
    _close(out, jo, 2e-5)
    _close(k_out, jk, 0, exact=True)
    _close(v_out, jv, 0, exact=True)


def test_fused_padding_row_writes_nothing_and_is_pinned():
    q, kp, vp, pt, lens = _paged_case(seed=17)
    k_pool, v_pool = kp[1].clone(), vp[1].clone()
    out, m, l, _, _ = pd_ops.fused_paged_decode_attention(
        q[1], k_pool, v_pool, pt[1], lens[1],
        torch.full((3, 2, 16), 1e6), torch.full((3, 2, 16), -1e6),
        return_lse=True)
    for pg in pt[1][-1].tolist():
        assert not torch.any(k_pool[pg] == 1e6)
        assert not torch.any(v_pool[pg] == -1e6)
    assert torch.all(out[-1] == 0)
    assert torch.all(m[-1] == np.float32(NEG_INF)) and torch.all(l[-1] == 0)


@pytest.mark.parametrize("page_size", [1, 2, 8, 16, 48])
@pytest.mark.parametrize("head_dim", list(pd_ops.HEAD_DIMS))
def test_paged_chunk_plan_covers_every_page_once(page_size, head_dim):
    """The split kernel's plan: a row's chunks [c*chunk, (c+1)*chunk) of
    whole pages cover each of its live pages once, whatever its length
    and the table's width; the stage of the copy ring holds whole pages
    within a chunk; B, the table's width and the lengths are no input of
    the plan."""
    chunk = pd_ops.plan_chunk_pages(page_size, head_dim)
    assert chunk >= 1 and isinstance(chunk, int)
    for n_pages in (1, 3, chunk, chunk + 1, 5 * chunk + 2):
        for length in range(-1, (n_pages + 2) * page_size, 3):
            live = 0 if length < 0 else min(length // page_size + 1,
                                             n_pages)
            n_chunks = pd_ops.row_chunks(length, page_size, n_pages, chunk)
            covered = np.zeros(n_pages, np.int64)
            for c in range(n_chunks):
                covered[c * chunk:min((c + 1) * chunk, live)] += 1
            assert np.all(covered[:live] == 1) and np.all(covered[live:] == 0)
            assert n_chunks <= -(-n_pages // chunk)
    for ppb in pd_ops.PAGES_PER_BLOCK:
        for elem in (2, 4):
            stage = pd_ops.stage_pages(ppb, page_size, head_dim, elem, chunk)
            assert 1 <= stage <= max(1, min(ppb, chunk))
    assert set(inspect.signature(pd_ops.plan_chunk_pages).parameters) == {
        "page_size", "head_dim"}


def _paged_split_inputs(B, n_pages, ps, H, Hkv, Dh, lens, dtype, seed):
    """Rows of the given lengths over a shuffled pool under a table
    ``n_pages`` wide; rows 0 and 1 alias their first three pages."""
    rng = np.random.default_rng(seed)
    P = B * n_pages + 3
    q = _pair(rng.normal(size=(B, H, Dh)), dtype)
    kp = _pair(rng.normal(size=(P, ps, Hkv, Dh)), dtype)
    vp = _pair(rng.normal(size=(P, ps, Hkv, Dh)), dtype)
    pt = np.asarray(rng.permutation(P)[:B * n_pages].reshape(B, n_pages),
                    np.int32)
    pt[1, :3] = pt[0, :3]
    return q, kp, vp, _ints(pt), _ints(lens)


def _paged_split_emulation(q, kp, vp, pt, lens, chunk):
    """The plain version over each planned chunk of pages (positions
    counted from the chunk's first page), combined by log-sum-exp."""
    ps = kp.shape[1]
    n_split = -(-pt.shape[1] // chunk)
    parts = []
    for c in range(n_split):
        sub = pt[:, c * chunk:(c + 1) * chunk].contiguous()
        parts.append(pd_ops.paged_decode_attention(
            q, kp, vp, sub, (lens - c * chunk * ps).to(torch.int32),
            return_lse=True))
    return parts


# (B, n_pages, page, H, Hkv, Dh, lengths): a padding row, a row shorter
# than one chunk, rows 0/1 sharing prefix pages, tables wider than every
# row
PAGED_SPLIT_CASES = [
    (4, 20, 8, 4, 2, 16, [8 * 15 + 3, 8 * 9, 5, -1]),
    (5, 12, 16, 8, 2, 64, [16 * 11 + 15, 16 * 4 + 1, 16 * 3 - 1, -1, 0]),
    (3, 9, 8, 4, 1, 256, [8 * 7 + 2, -1, 1]),
    (4, 70, 8, 16, 8, 128, [8 * 65 - 3, 8 * 8, 8 * 8 - 1, -1]),
]


@pytest.mark.parametrize("B,n_pages,ps,H,Hkv,Dh,lens", PAGED_SPLIT_CASES)
def test_paged_split_then_combine_equals_the_whole(B, n_pages, ps, H, Hkv,
                                                   Dh, lens):
    """A plain emulation of the split kernel, the plain version per
    planned chunk combined by log-sum-exp, equals the whole row in f32."""
    q, kp, vp, pt, ln = _paged_split_inputs(B, n_pages, ps, H, Hkv, Dh,
                                            lens, "float32", seed=B + Dh)
    chunk = pd_ops.plan_chunk_pages(ps, Dh)
    whole, m, l = pd_ops.paged_decode_attention(q[1], kp[1], vp[1], pt[1],
                                                ln[1], return_lse=True)
    parts = _paged_split_emulation(q[1], kp[1], vp[1], pt[1], ln[1], chunk)
    counts = [pd_ops.row_chunks(n, ps, n_pages, chunk) for n in lens]
    assert max(counts) > 1 and min(counts) == 0
    assert any(0 < n <= 1 for n in counts)
    torch.testing.assert_close(lse_combine(parts), whole, atol=1e-6,
                               rtol=1e-6)
    m_c = torch.stack([p[1] for p in parts]).amax(0)
    l_c = sum(torch.exp(p[1] - m_c) * p[2] for p in parts)
    torch.testing.assert_close(torch.where(l_c == 0, NEG_INF, m_c), m,
                               atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(l_c, l, atol=1e-6, rtol=1e-6)
    # chunks past a row's last page hold nothing
    for b, n in enumerate(counts):
        for c, p in enumerate(parts):
            assert bool(p[2][b].eq(0).all()) == (c >= n), (b, c)
    for b, n in enumerate(lens):
        assert bool(torch.all(whole[b] == 0)) == (n < 0), b


@pytest.mark.parametrize("B,n_pages,ps,H,Hkv,Dh,lens", PAGED_SPLIT_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_split_emulation_matches_jax_ref(B, n_pages, ps, H, Hkv, Dh,
                                               lens, dtype):
    """The split's emulation and the whole against the JAX reference on
    the same numpy inputs."""
    q, kp, vp, pt, ln = _paged_split_inputs(B, n_pages, ps, H, Hkv, Dh,
                                            lens, dtype, seed=B + Dh)
    chunk = pd_ops.plan_chunk_pages(ps, Dh)
    ref, mr, lr = j_paged_ref(q[0], kp[0], vp[0], pt[0], ln[0],
                              return_lse=True)
    parts = _paged_split_emulation(q[1], kp[1], vp[1], pt[1], ln[1], chunk)
    _close(lse_combine(parts), ref, _tol(dtype))
    whole, m, l = pd_ops.paged_decode_attention(q[1], kp[1], vp[1], pt[1],
                                                ln[1], return_lse=True)
    _close(whole, ref, _tol(dtype))
    _close(m, mr, 2e-5)
    _close(l, lr, 2e-5)


# ------------------------------------------------ decode over a ring cache

def _ring_inputs(B, T, H, Hkv, Dh, dtype, seed=5):
    """A ring cache of T slots, position p in slot p % T: row 0 has
    wrapped, row 1 has not (its tail slots are empty, -1), and the last
    row has no valid key at all."""
    rng = np.random.default_rng(seed)
    q = _pair(rng.normal(size=(B, H, Dh)), dtype)
    k = _pair(rng.normal(size=(B, T, Hkv, Dh)), dtype)
    v = _pair(rng.normal(size=(B, T, Hkv, Dh)), dtype)
    qp = rng.integers(0, 3 * T, size=(B,))
    qp[0], qp[1] = 2 * T + 3, T // 2
    slots = np.arange(T)[None, :]
    kp = qp[:, None] - np.mod(qp[:, None] - slots, T)
    kp = np.where(kp >= 0, kp, -1)
    kp[-1] = -1
    return q, k, v, _ints(qp), _ints(kp)


@pytest.mark.parametrize("H,Hkv,Dh", [(2, 2, 32), (4, 2, 32), (10, 1, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 7])
def test_decode_ring_sweep_matches_jax_ref(H, Hkv, Dh, dtype, window):
    q, k, v, qp, kp = _ring_inputs(3, 24, H, Hkv, Dh, dtype)
    out, m, l = da_ops.decode_attention(
        q[1], k[1], v[1], q_positions=qp[1], kv_positions=kp[1],
        window=window, return_lse=True)
    ref, mr, lr = j_decode_ref(q[0], k[0], v[0], q_positions=qp[0],
                               kv_positions=kp[0], window=window,
                               return_lse=True)
    assert out.dtype == q[1].dtype
    _close(out, ref, _tol(dtype))
    _close(m, mr, 2e-5)
    _close(l, lr, 2e-5)
    assert torch.all(out[-1] == 0)                 # no valid key: pinned
    assert torch.all(m[-1] == np.float32(NEG_INF)) and torch.all(l[-1] == 0)


def test_decode_matches_pallas_interpret_one_token_rank4():
    q, k, v, qp, kp = _ring_inputs(3, 32, 10, 1, 256, "float32", seed=9)
    out = da_ops.decode_attention(q[1][:, None], k[1], v[1],
                                  q_positions=qp[1][:, None],
                                  kv_positions=kp[1], window=20)
    pallas = j_decode(q[0][:, None], k[0], v[0], q_positions=qp[0][:, None],
                      kv_positions=kp[0], window=20, block_t=16,
                      interpret=True)
    assert tuple(out.shape) == (3, 1, 10, 256)
    _close(out, pallas, 2e-5)


def test_lse_combine_of_split_halves_equals_the_whole():
    q, k, v, qp, kp = _ring_inputs(3, 32, 4, 2, 32, "float32", seed=13)
    whole = da_ops.decode_attention(q[1], k[1], v[1], q_positions=qp[1],
                                    kv_positions=kp[1], window=11)
    t_parts, j_parts = [], []
    for lo in (0, 16):
        sl = slice(lo, lo + 16)
        t_parts.append(da_ops.decode_attention(
            q[1], k[1][:, sl].contiguous(), v[1][:, sl].contiguous(),
            q_positions=qp[1], kv_positions=kp[1][:, sl].contiguous(),
            window=11, return_lse=True))
        j_parts.append(j_decode_ref(q[0], k[0][:, sl], v[0][:, sl],
                                    q_positions=qp[0],
                                    kv_positions=kp[0][:, sl], window=11,
                                    return_lse=True))
    merged = lse_combine(t_parts)
    _close(merged, whole.numpy(), 2e-5)
    _close(merged, j_lse_combine(j_parts), 2e-5)


@pytest.mark.parametrize("T", [1, 24, 64, 100, 517, 2048, 5000, 70000])
@pytest.mark.parametrize("Dh", [32, 64, 128, 256])
@pytest.mark.parametrize("n_sm", [1, 4, 132])
def test_decode_chunk_plan_covers_every_key_once(T, Dh, n_sm):
    """The split kernel's plan: chunks [c*chunk, min((c+1)*chunk, T)) cover
    each key once, the chunk is whole sub-tiles (so whole 16-byte vectors
    of bf16 and f32 rows), there are at most one chunk per SM, and B is no
    input of the plan."""
    chunk, n_chunks = da_ops.plan_chunks(T, Dh, n_sm)
    covered = np.zeros(T, np.int64)
    for c in range(n_chunks):
        covered[c * chunk:min((c + 1) * chunk, T)] += 1
    assert np.all(covered == 1)
    assert (n_chunks - 1) * chunk < T <= n_chunks * chunk
    assert chunk % da_ops.sub_tile(Dh) == 0
    for elem_bytes in (2, 4):
        assert chunk % (da_ops.VECTOR_BYTES // elem_bytes) == 0
    assert n_chunks <= n_sm
    assert set(inspect.signature(da_ops.plan_chunks).parameters) == {
        "T", "head_dim", "n_sm"}


@pytest.mark.parametrize("T,H,Hkv,Dh,n_sm,window", [
    (100, 4, 2, 64, 4, 0), (517, 10, 1, 256, 4, 0), (517, 10, 1, 256, 2, 90),
    (300, 16, 8, 128, 132, 0), (2048, 2, 1, 32, 8, 700)])
def test_decode_split_then_combine_equals_the_whole(T, H, Hkv, Dh, n_sm,
                                                     window):
    """A plain emulation of the split kernel: the plain version over each
    planned chunk, combined by log-sum-exp, equals it over all T in f32,
    with whole chunks of empty slots and a row without a valid key."""
    q, k, v, qp, kp = _ring_inputs(4, T, H, Hkv, Dh, "float32", seed=17)
    q, k, v, qp, kp = q[1], k[1], v[1], qp[1], kp[1]
    chunk, n_chunks = da_ops.plan_chunks(T, Dh, n_sm)
    kp[1, chunk // 2:chunk // 2 + 2 * chunk] = -1     # empty chunks
    whole, m, l = da_ops.decode_attention(q, k, v, q_positions=qp,
                                          kv_positions=kp, window=window,
                                          return_lse=True)
    parts = [da_ops.decode_attention(
        q, k[:, c * chunk:(c + 1) * chunk].contiguous(),
        v[:, c * chunk:(c + 1) * chunk].contiguous(), q_positions=qp,
        kv_positions=kp[:, c * chunk:(c + 1) * chunk].contiguous(),
        window=window, return_lse=True) for c in range(n_chunks)]
    assert n_chunks > 1
    assert any(bool(torch.all(p[2][1] == 0)) for p in parts)
    torch.testing.assert_close(lse_combine(parts), whole, atol=1e-6,
                               rtol=1e-6)
    m_c = torch.stack([p[1] for p in parts]).amax(0)
    l_c = sum(torch.exp(p[1] - m_c) * p[2] for p in parts)
    torch.testing.assert_close(torch.where(l_c == 0, NEG_INF, m_c), m,
                               atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(l_c, l, atol=1e-6, rtol=1e-6)
    assert torch.all(whole[-1] == 0) and torch.all(l[-1] == 0)


# ------------------------------------------------------ RG-LRU scan

@pytest.mark.parametrize("B,S,D", [(2, 37, 70), (1, 19, 600), (3, 1, 5)])
def test_linear_scan_matches_jax_ref_and_pallas_interpret(B, S, D):
    rng = np.random.default_rng(S * D)
    a = rng.uniform(0.5, 1.0, size=(B, S, D)).astype(np.float32)
    b = rng.normal(size=(B, S, D)).astype(np.float32)
    out = lru_ops.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    _close(out, j_linear_scan_ref(ja, jb), 1e-5)
    _close(out, j_linear_scan(ja, jb, interpret=True), 1e-5)
    h0 = rng.normal(size=(B, D)).astype(np.float32)
    _close(linear_scan_ref(torch.from_numpy(a), torch.from_numpy(b),
                           torch.from_numpy(h0)),
           j_linear_scan_ref(ja, jb, jnp.asarray(h0)), 1e-5)


# ------------------------------------------- shared-prefix decode attention

def _prefix_case(B, H, Hkv, Dh, P, Ts, dtype, seed=21):
    """q, the shared prefix and per-row suffixes of Ts slots.  Row 0 sees
    its whole suffix; a middle row has a ragged suffix (its tail slots
    -1); with B >= 3 the last-but-one row's suffix is all -1 and the last
    row's query sits before the prefix's end (q_position < P - 1), so its
    suffix is masked and only the prefix counts."""
    rng = np.random.default_rng(seed)
    arrays = [_pair(rng.normal(size=shape), dtype) for shape in (
        (B, H, Dh), (P, Hkv, Dh), (P, Hkv, Dh), (B, Ts, Hkv, Dh),
        (B, Ts, Hkv, Dh))]
    lens = rng.integers(1, Ts + 1, size=(B,))
    lens[0] = Ts
    qp = P + lens - 1
    if B >= 3:
        lens[-2] = 0
        qp[-1] = P // 3
    sp = np.where(np.arange(Ts)[None, :] < lens[:, None],
                  P + np.arange(Ts)[None, :], -1)
    return arrays, _ints(qp), _ints(sp)


@pytest.mark.parametrize("B,H,Hkv,Dh,P,bp", [
    (2, 4, 2, 16, 32, 16), (3, 8, 2, 32, 64, 32), (2, 10, 1, 32, 37, 37),
    (4, 4, 4, 16, 48, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefix_attention_matches_pallas_kernel_interpret(B, H, Hkv, Dh, P,
                                                          bp, dtype):
    """The plain version of the prefix kernel against the Pallas kernel,
    on the unnormalized (acc, m, l); some prefix slots are -1."""
    (q, pk, pv, _, _), _, _ = _prefix_case(B, H, Hkv, Dh, P, 4, dtype)
    pos = np.arange(P, dtype=np.int32)
    pos[RNG.permutation(P)[:P // 5]] = -1
    pos = _ints(pos)
    acc, m, l = sp_ops.prefix_attention(q[1], pk[1], pv[1], pos[1])
    ja, jm, jl = j_prefix_kernel(q[0], pk[0], pv[0], pos[0], block_p=bp,
                                 interpret=True)
    assert acc.dtype == m.dtype == l.dtype == torch.float32
    # acc is unnormalized (up to l times a value): f32 relative tolerance
    for a, b in ((acc, ja), (m, jm), (l, jl)):
        _close(a, b, 2e-5)


def test_prefix_attention_with_no_valid_key_is_pinned():
    (q, pk, pv, _, _), _, _ = _prefix_case(3, 4, 2, 16, 16, 4, "float32")
    pos = _ints(np.full((16,), -1))
    acc, m, l = sp_ops.prefix_attention(q[1], pk[1], pv[1], pos[1])
    ja, jm, jl = j_prefix_kernel(q[0], pk[0], pv[0], pos[0], block_p=8,
                                 interpret=True)
    assert torch.all(acc == 0) and torch.all(l == 0)
    assert torch.all(m == np.float32(NEG_INF))
    for a, b in ((acc, ja), (m, jm), (l, jl)):
        _close(a, b, 0, exact=True)


@pytest.mark.parametrize("P,Ts", [(32, 16), (64, 32), (37, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_prefix_op_matches_jax_op_interpret(P, Ts, dtype):
    """The sweep of tests/test_kernels.py plus a prime P, a row whose
    suffix is all -1 and a query before the prefix's end."""
    (q, pk, pv, sk, sv), qp, sp = _prefix_case(4, 4, 2, 16, P, Ts, dtype)
    out = sp_ops.shared_prefix_attention(
        q[1], pk[1], pv[1], sk[1], sv[1], q_positions=qp[1],
        suffix_positions=sp[1])
    ref = j_shared_prefix(q[0], pk[0], pv[0], sk[0], sv[0],
                          q_positions=qp[0], suffix_positions=sp[0],
                          block_p=16, block_t=8, interpret=True)
    assert out.dtype == q[1].dtype
    _close(out, ref, _tol(dtype))


@pytest.mark.parametrize("P,Ts", [(32, 16), (64, 32), (37, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_prefix_op_matches_jax_ref_where_queries_follow_prefix(
        P, Ts, dtype):
    """Where every q_position >= P - 1 the JAX oracle's prefix mask
    (kp <= qp) hides nothing, and the port equals it."""
    (q, pk, pv, sk, sv), qp, sp = _prefix_case(3, 8, 2, 32, P, Ts, dtype,
                                               seed=P)
    qp = _ints(np.maximum(qp[1].numpy(), P - 1))
    out = sp_ops.shared_prefix_attention(
        q[1], pk[1], pv[1], sk[1], sv[1], q_positions=qp[1],
        suffix_positions=sp[1])
    ref = j_shared_prefix_ref(q[0], pk[0], pv[0], sk[0], sv[0],
                              q_positions=qp[0], suffix_positions=sp[0])
    _close(out, ref, _tol(dtype))


def test_jax_ref_and_op_disagree_before_the_prefix_end_port_follows_op():
    """At q_position < P - 1 the JAX oracle masks prefix keys past the
    query (decode_attention/ref.py:26) and the Pallas kernel does not
    (shared_prefix_attention/kernel.py:49).  The port follows the op."""
    B, H, Hkv, Dh, P, Ts = 2, 4, 2, 16, 32, 16
    (q, pk, pv, sk, sv), _, sp = _prefix_case(B, H, Hkv, Dh, P, Ts,
                                              "float32")
    sp = _ints(np.broadcast_to(P + np.arange(Ts), (B, Ts)))
    qp = _ints([P + Ts - 1, 10])              # row 1 sits before P - 1
    args = dict(q_positions=qp[0], suffix_positions=sp[0])
    j_op = np.asarray(j_shared_prefix(q[0], pk[0], pv[0], sk[0], sv[0],
                                      block_p=16, block_t=8, interpret=True,
                                      **args))
    j_ref = np.asarray(j_shared_prefix_ref(q[0], pk[0], pv[0], sk[0], sv[0],
                                           **args))
    t_args = dict(q_positions=qp[1], suffix_positions=sp[1])
    port = sp_ops.shared_prefix_attention(q[1], pk[1], pv[1], sk[1], sv[1],
                                          **t_args)
    np.testing.assert_allclose(j_op[0], j_ref[0], atol=2e-5, rtol=2e-5)
    assert np.abs(j_op[1] - j_ref[1]).max() > 0.1
    _close(port, j_op, 2e-5)


@pytest.mark.parametrize("P", [1, 37, 64, 131, 2048, 5000, 70000])
@pytest.mark.parametrize("Dh", [64, 128, 256])
@pytest.mark.parametrize("Hkv,n_sm", [(1, 132), (8, 132), (2, 4), (8, 1)])
def test_prefix_chunk_plan_covers_every_key_once(P, Dh, Hkv, n_sm):
    """The prefix kernel's plan: chunks [c*chunk, min((c+1)*chunk, P))
    cover each key once, the chunk is whole sub-tiles (the tensor-core
    body's tiles: 16 keys for each of its key-splitting warps), a head's
    chunks fill at most its share of whole clusters, one cluster a head at
    least, and B is no input of the plan."""
    chunk, n_chunks = sp_ops.plan_chunks(P, Dh, Hkv, n_sm)
    covered = np.zeros(P, np.int64)
    for c in range(n_chunks):
        covered[c * chunk:min((c + 1) * chunk, P)] += 1
    assert np.all(covered == 1)
    assert (n_chunks - 1) * chunk < P <= n_chunks * chunk
    assert chunk % sp_ops.sub_tile(Dh) == 0 and chunk % 16 == 0
    clusters = -(-n_chunks // sp_ops.CLUSTER)
    assert clusters == 1 or Hkv * clusters <= n_sm // (2 * sp_ops.CLUSTER)
    assert set(inspect.signature(sp_ops.plan_chunks).parameters) == {
        "P", "head_dim", "n_kv_heads", "n_sm"}


def _lse_merge(parts):
    """(acc, m, l) partials merged by log-sum-exp in their order."""
    m = torch.stack([p[1] for p in parts]).amax(0)
    acc = torch.zeros_like(parts[0][0])
    l = torch.zeros_like(parts[0][2])
    for a_c, m_c, l_c in parts:
        w = torch.exp(m_c - m)
        l = l + w * l_c
        acc = acc + w[..., None] * a_c
    return acc, m, l


def _prefix_split_emulation(q, pk, pv, chunk, n_chunks):
    """The tensor-core body's arithmetic in plain torch: the plain prefix
    pass over each planned chunk, merged by log-sum-exp in chunk order
    within each cluster of ``CLUSTER`` chunks, then the clusters in order,
    pinned where no key was valid."""
    P = pk.shape[0]
    parts = [prefix_attention_ref(
        q, pk[c * chunk:(c + 1) * chunk].contiguous(),
        pv[c * chunk:(c + 1) * chunk].contiguous(),
        torch.arange(c * chunk, min((c + 1) * chunk, P), dtype=torch.int32))
        for c in range(n_chunks)]
    cl = sp_ops.CLUSTER
    acc, m, l = _lse_merge([_lse_merge(parts[i:i + cl])
                            for i in range(0, n_chunks, cl)])
    empty = l == 0
    return (torch.where(empty[..., None], 0.0, acc),
            torch.where(empty, NEG_INF, m), l)


@pytest.mark.parametrize("P,block_p,n_sm", [(131, 131, 8), (2048, 512, 8),
                                           (2048, 512, 132)])
def test_prefix_split_emulation_matches_jax_op_interpret(P, block_p, n_sm):
    """The kernel's split, emulated (chunks of the plan, merged in chunk
    order within clusters and the clusters in order, then merged with the
    suffix pass), against the JAX op with its Pallas kernels in interpret
    mode: P prime and P=2048 (in one cluster and, at 132 SMs, in four),
    ragged suffixes, an all -1 suffix and a query before the prefix's
    end."""
    B, H, Hkv, Dh, Ts = 4, 4, 2, 64, 64
    (q, pk, pv, sk, sv), qp, sp = _prefix_case(B, H, Hkv, Dh, P, Ts,
                                               "float32", seed=P)
    chunk, n_chunks = sp_ops.plan_chunks(P, Dh, Hkv, n_sm)
    assert n_chunks > 1
    prefix = _prefix_split_emulation(q[1], pk[1], pv[1], chunk, n_chunks)
    suffix = da_ops.decode_attention(q[1], sk[1], sv[1], q_positions=qp[1],
                                     kv_positions=sp[1], return_lse=True)
    out = merge_prefix_suffix(prefix, suffix, torch.float32)
    ref = j_shared_prefix(q[0], pk[0], pv[0], sk[0], sv[0],
                          q_positions=qp[0], suffix_positions=sp[0],
                          block_p=block_p, block_t=32, interpret=True)
    _close(out, ref, 2e-5)
    whole = sp_ops.prefix_attention(q[1], pk[1], pv[1],
                                    torch.arange(P, dtype=torch.int32))
    for a, b in zip(prefix, whole):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("terms,within", [(2, False), (3, True)])
def test_prefix_pv_split_of_p_into_bf16_terms(terms, within):
    """The tensor-core body feeds p to the PV product as bf16 terms, each
    the rounding of what the ones before leave, times bf16 V, summed in
    f32.  At the smoke's full shapes (B=32, H=16, Hkv=8, Dh=128, P=2048,
    seed 13) three terms stay within the kernel's limit of 2e-5 + 2e-5 x
    |acc| of the f32 product; two terms (about 2^-17 p) do not, which is
    why the kernel takes three."""
    B, H, Hkv, Dh, P = 32, 16, 8, 128, 2048
    G = H // Hkv
    rng = np.random.default_rng(13)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(torch.bfloat16).float()
               for s in ((B, H, Dh), (P, Hkv, Dh), (P, Hkv, Dh)))
    qf = q.reshape(B, Hkv, G, Dh).transpose(0, 1).reshape(Hkv, B * G, Dh)
    s = torch.einsum("hrd,phd->hrp", qf, k) / np.sqrt(Dh)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    vh = v.transpose(0, 1)
    exact = p @ vh
    rest, split = p, torch.zeros_like(exact)
    for _ in range(terms):
        term = rest.to(torch.bfloat16).float()
        split = split + term @ vh
        rest = rest - term
    err = (split - exact).abs()
    ratio = (err / (2e-5 + 2e-5 * exact.abs())).max().item()
    assert (ratio <= 1.0) == within, ratio


# ------------------------------------------------------ online softmax

def test_online_softmax_update_and_finalize_match_jax():
    R, C, Dh = 4, 8, 16
    logits = RNG.normal(size=(R, C)).astype(np.float32)
    mask = RNG.random(size=(R, C)) > 0.3
    mask[2] = False                              # a fully masked row
    v = RNG.normal(size=(C, Dh)).astype(np.float32)
    acc = RNG.normal(size=(R, Dh)).astype(np.float32)
    acc[2] = 0.0
    m = RNG.normal(size=(R,)).astype(np.float32)
    m[2] = NEG_INF
    l = np.abs(RNG.normal(size=(R,))).astype(np.float32)
    l[2] = 0.0
    t = [torch.from_numpy(x.copy()) for x in (logits, mask, v, acc, m, l)]
    j = [jnp.asarray(x) for x in (logits, mask, v, acc, m, l)]
    t_state = common.online_softmax_update(*t)
    j_state = jcommon.online_softmax_update(*j)
    for a, b in zip(t_state, j_state):
        _close(a, b, 2e-5)
    for a, b in zip(common.finalize_online_softmax(*t_state),
                    jcommon.finalize_online_softmax(*j_state)):
        _close(a, b, 2e-5)
    out, m_fin, _ = common.finalize_online_softmax(*t_state)
    assert torch.all(out[2] == 0) and m_fin[2] == np.float32(NEG_INF)
    _close(common.qk_logits(t[3], t[2], 0.25),
           jcommon.qk_logits(j[3], j[2], 0.25), 2e-5)
