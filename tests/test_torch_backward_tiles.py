"""The backward kernels' order of work, emulated on the CPU.

The CUDA kernels of the port's backward run only on the card; what they
compute in which order is written out here in plain torch and held to the
plain versions, so a scheme that cannot meet the card's checks fails
before any card time.

* The scan's backward (``csrc/rglru_scan.cu``, ``linear_scan_bwd_kernel``)
  walks time from the last step with g in a register;
  ``linear_scan_bwd_ref`` is that walk.  It must equal, bit for bit, the
  forward scan run over the time-reversed ``(a shifted by one, dh)``, the
  construction the backward used before, and ``jax.vjp`` of the JAX
  package's scans to 1e-5 of the gradient's scale.
* The flash backward's tensor-core body (``csrc/flash_attention_bwd.cu``,
  namespace ``tc``): bf16 operands, f32 sums; D = rowsum(P o dP) summed
  over 64-key tiles in order (at Dh 256 each tile's two 32-key halves by
  their own warps, added at the end); P rounded to bf16 before dV; dS
  split into two bf16 terms (hi + lo) before dK and dQ; each split of a
  group's query heads summing its own f32 partial dK and dV, added in split
  order, scaled and rounded once.  Held to ``flash_attention_bwd_ref``
  under the card's bf16 rule (every element within 2e-3 + 8e-3 |ref|, the
  RMS error within 5% of the reference's RMS) at small cuts of the
  training shapes; the schemes it does not take (dS as one bf16 term, D
  from the forward's output) must fail the same rule.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.kernels.rglru_scan.ref import (  # noqa: E402
    linear_scan_ref as jax_scan_ref)
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_lse_ref)
from repro_torch.kernels.rglru_scan.ref import (  # noqa: E402
    linear_scan_bwd_ref, linear_scan_ref)

KEY_TILE = 64                   # keys a dK/dV block holds; a walk's step
SM_COUNT = 132                  # an H100 SXM's SMs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ scan

def _scan_bwd_by_flips(a, h, dh):
    """The adjoint as the forward scan over the reversed, shifted inputs."""
    a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
    g = linear_scan_ref(a_next.flip(1), dh.flip(1)).flip(1)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    return g * h_prev, g


def _scan_inputs(B, S, D, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, size=(B, S, D)).astype(np.float32)
    b = rng.normal(size=(B, S, D)).astype(np.float32)
    dh = rng.normal(size=(B, S, D)).astype(np.float32)
    return a, b, dh


@pytest.mark.parametrize("B,S,D", [(2, 37, 70), (3, 129, 16), (1, 1, 33),
                                   (2, 200, 8)])
def test_scan_reverse_walk_equals_the_flipped_forward_bitwise(B, S, D):
    a, b, dh = (torch.from_numpy(x) for x in _scan_inputs(B, S, D, S + D))
    h = linear_scan_ref(a, b)
    da, db = linear_scan_bwd_ref(a, h, dh)
    fa, fb = _scan_bwd_by_flips(a, h, dh)
    assert torch.equal(da, fa) and torch.equal(db, fb)


def _assoc_scan(a, b):
    def combine(e1, e2):
        a1, b1 = e1
        a2, b2 = e2
        return a1 * a2, a2 * b1 + b2
    return lax.associative_scan(combine, (a, b), axis=1)[1]


@pytest.mark.parametrize("jax_fn", ["associative", "sequential"])
@pytest.mark.parametrize("B,S,D", [(2, 65, 9), (1, 130, 4)])
def test_scan_reverse_walk_equals_jax_vjp(B, S, D, jax_fn):
    a, b, dh = _scan_inputs(B, S, D, 7 * S + D)
    fn = _assoc_scan if jax_fn == "associative" else jax_scan_ref
    _, vjp = jax.vjp(fn, jnp.asarray(a), jnp.asarray(b))
    ja, jb = vjp(jnp.asarray(dh))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    da, db = linear_scan_bwd_ref(ta, linear_scan_ref(ta, tb),
                                 torch.from_numpy(dh))
    for got, want in ((da, ja), (db, jb)):
        want = np.asarray(want, np.float32)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * scale,
                                   rtol=1e-5)


# ----------------------------------------------------------------- flash

def _bf16(x):
    return x.to(torch.bfloat16).float()


def emulate_flash_bwd(q, k, v, do, qp, kp, causal, window, n_split,
                      ds_terms=2, d_from="p_dp"):
    """The tensor-core body's arithmetic on bf16 q, k, v, do: returns
    (dq, dk, dv) in bf16.  Schemes the kernel does not take: ``ds_terms``
    1 feeds dS to dK and dQ as one bf16 term; ``d_from`` "o_f32" or
    "o_bf16" takes D = rowsum(dO o O) with the forward's O (P rounded to
    bf16 before PV) in f32 or rounded to bf16, as FA2 does."""
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(Dh)
    lse = flash_attention_lse_ref(q, k, q_positions=qp, kv_positions=kp,
                                  causal=causal, window=window)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    qq, kk = qp[:, :, None], kp[:, None, :]
    mask = (kk >= 0).expand(B, Sq, Skv)
    if causal:
        mask = mask & (kk <= qq)
    if window:
        mask = mask & (kk > qq - window)
    halves = 2 if Dh == 256 else 1          # warps sharing a 64-key step
    dq = torch.zeros(B, Sq, H, Dh)
    dk_part = torch.zeros(n_split, B, Skv, Hkv, Dh)
    dv_part = torch.zeros(n_split, B, Skv, Hkv, Dh)
    for b in range(B):
        for h in range(H):
            hk, split = h // G, (h % G) // (G // n_split)
            L = lse[b, h][:, None]
            keyless = L <= -0.5e30
            s = qf[b, :, h] @ kf[b, :, hk].T
            p = torch.where(mask[b] & ~keyless, torch.exp(s * scale - L), 0.0)
            dp = dof[b, :, h] @ vf[b, :, hk].T
            # D: each warp's share of every 64-key tile in tile order, the
            # shares added at the end
            D = torch.zeros(Sq)
            share = KEY_TILE // halves
            for w in range(halves):
                part = torch.zeros(Sq)
                for t0 in range(w * share, Skv, KEY_TILE):
                    cols = slice(t0, min(t0 + share, Skv))
                    part = part + (p[:, cols] * dp[:, cols]).sum(-1)
                D = D + part if w else part
            if d_from != "p_dp":
                o = _bf16(torch.where(keyless, 1.0 / Skv, p)) @ vf[b, :, hk]
                o = _bf16(o) if d_from == "o_bf16" else o
                D = torch.where(keyless[:, 0], 0.0, (dof[b, :, h] * o).sum(-1))
            ds = p * (dp - D[:, None])
            terms = [_bf16(ds)]
            if ds_terms == 2:
                terms.append(_bf16(ds - terms[0]))
            p_v = torch.where(keyless, 1.0 / Skv, p)
            dv_part[split, b, :, hk] += _bf16(p_v).T @ dof[b, :, h]
            for t in terms:
                dk_part[split, b, :, hk] += t.T @ qf[b, :, h]
            # dQ: each warp's keys of every step, the halves added at the
            # end
            acc = []
            for w in range(halves):
                keys = torch.zeros(Skv, dtype=torch.bool)
                for t0 in range(w * share, Skv, KEY_TILE):
                    keys[t0:t0 + share] = True
                a = torch.zeros(Sq, Dh)
                for t in terms:
                    a = a + torch.where(keys, t, 0.0) @ kf[b, :, hk]
                acc.append(a)
            dq[b, :, h] = (acc[0] + acc[1] if halves == 2 else acc[0]) * scale
    dk = dk_part[0]
    dv = dv_part[0]
    for i in range(1, n_split):
        dk = dk + dk_part[i]
        dv = dv + dv_part[i]
    return (dq.to(torch.bfloat16), (dk * scale).to(torch.bfloat16),
            dv.to(torch.bfloat16))


def _bwd_close(got, ref):
    """The card's bf16 rule: (holds, worst element's error over its bound,
    RMS error over the reference's RMS)."""
    g, r = got.float(), ref.float()
    worst = float(((g - r).abs() / (2e-3 + 8e-3 * r.abs())).max())
    rms = float((g - r).pow(2).mean().sqrt() / r.pow(2).mean().sqrt())
    return worst <= 1.0 and rms <= 0.05, worst, rms


# name: B, Sq, Skv, H, Hkv, Dh, causal, window, valid keys, keyless row
FLASH_CUTS = {
    "qwen3": (1, 96, 96, 4, 2, 128, True, 0, 96, False),
    "hybrid": (1, 96, 96, 10, 1, 256, True, 2048, 96, False),
    "hybrid_window": (1, 96, 96, 10, 1, 256, True, 40, 96, True),
    "whisper_encoder": (1, 100, 100, 2, 2, 64, False, 0, 100, False),
    "whisper_cross": (2, 32, 100, 2, 2, 64, False, 0, 70, False),
    "keyless_row": (2, 70, 70, 4, 2, 128, True, 0, 70, True),
}


def _flash_case(name, seed=0):
    B, Sq, Skv, H, Hkv, Dh, causal, window, valid, keyless = FLASH_CUTS[name]
    rng = np.random.default_rng(seed)

    def bf(*s):
        return torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
            torch.bfloat16)

    q, k, v, do = bf(B, Sq, H, Dh), bf(B, Skv, Hkv, Dh), bf(B, Skv, Hkv, Dh), \
        bf(B, Sq, H, Dh)
    qp = torch.arange(Sq, dtype=torch.int32).expand(B, Sq).contiguous()
    if causal:
        qp = qp + (Skv - Sq)
    kp = torch.arange(Skv, dtype=torch.int32)[None].expand(B, Skv)
    kp = torch.where(kp < valid, kp, -1).to(torch.int32).contiguous()
    if keyless:
        qp[0, 3] = -1                      # before every key
    return q, k, v, do, qp, kp, causal, window


@pytest.mark.parametrize("name", sorted(FLASH_CUTS))
def test_flash_bwd_emulation_meets_the_bf16_rule(name):
    q, k, v, do, qp, kp, causal, window = _flash_case(name)
    B, Skv, Hkv = k.shape[0], k.shape[1], k.shape[2]
    G = q.shape[2] // Hkv
    n_split = fa_ops.bwd_head_split(B, Skv, Hkv, G, SM_COUNT)
    got = emulate_flash_bwd(q, k, v, do, qp, kp, causal, window, n_split)
    ref = flash_attention_bwd_ref(q, k, v, do, q_positions=qp,
                                  kv_positions=kp, causal=causal,
                                  window=window)
    for n, a, r in zip("qkv", got, ref):
        ok, worst, rms = _bwd_close(a, r)
        assert ok, (name, f"d{n}", worst, rms)


@pytest.mark.parametrize("n_split", [1, 2, 5, 10])
def test_flash_bwd_emulation_holds_at_every_head_split(n_split):
    """The hybrid's G = 10 heads summed in 1, 2, 5 or 10 partials."""
    q, k, v, do, qp, kp, causal, window = _flash_case("hybrid", seed=3)
    got = emulate_flash_bwd(q, k, v, do, qp, kp, causal, window, n_split)
    ref = flash_attention_bwd_ref(q, k, v, do, q_positions=qp,
                                  kv_positions=kp, causal=causal,
                                  window=window)
    for n, a, r in zip("qkv", got, ref):
        ok, worst, rms = _bwd_close(a, r)
        assert ok, (n_split, f"d{n}", worst, rms)


@pytest.mark.parametrize("name", ["qwen3", "hybrid", "keyless_row"])
def test_flash_bwd_emulation_with_one_bf16_ds_term_fails_the_rule(name):
    """The control: dS as one bf16 term puts dQ or dK past the rule, so the
    rule sees the 16 bits the kernel keeps."""
    q, k, v, do, qp, kp, causal, window = _flash_case(name)
    B, Skv, Hkv = k.shape[0], k.shape[1], k.shape[2]
    n_split = fa_ops.bwd_head_split(B, Skv, Hkv, q.shape[2] // Hkv, SM_COUNT)
    got = emulate_flash_bwd(q, k, v, do, qp, kp, causal, window, n_split,
                            ds_terms=1)
    ref = flash_attention_bwd_ref(q, k, v, do, q_positions=qp,
                                  kv_positions=kp, causal=causal,
                                  window=window)
    assert not all(_bwd_close(a, r)[0] for a, r in zip(got[:2], ref[:2]))


@pytest.mark.parametrize("d_from", ["o_f32", "o_bf16"])
@pytest.mark.parametrize("name", ["qwen3", "hybrid"])
def test_flash_bwd_emulation_with_d_from_the_forward_output_fails(name,
                                                                  d_from):
    """Why D has its own walk: D = rowsum(dO o O) from the forward's O,
    whose P was rounded to bf16 before PV, puts dQ or dK past the rule,
    in f32 and rounded alike."""
    q, k, v, do, qp, kp, causal, window = _flash_case(name)
    B, Skv, Hkv = k.shape[0], k.shape[1], k.shape[2]
    n_split = fa_ops.bwd_head_split(B, Skv, Hkv, q.shape[2] // Hkv, SM_COUNT)
    got = emulate_flash_bwd(q, k, v, do, qp, kp, causal, window, n_split,
                            d_from=d_from)
    ref = flash_attention_bwd_ref(q, k, v, do, q_positions=qp,
                                  kv_positions=kp, causal=causal,
                                  window=window)
    assert not all(_bwd_close(a, r)[0] for a, r in zip(got[:2], ref[:2]))


def test_bwd_head_split_fills_the_card_with_the_fewest_splits():
    # the hybrid: 8 key tiles x 1 KV head x 4 rows = 32 blocks, G = 10
    assert fa_ops.bwd_head_split(4, 512, 1, 10, SM_COUNT) == 5
    # qwen3 (512 blocks) and whisper (1152) need no split
    assert fa_ops.bwd_head_split(8, 512, 8, 2, SM_COUNT) == 1
    assert fa_ops.bwd_head_split(8, 1500, 6, 1, SM_COUNT) == 1
    # no divisor reaches the card: every head its own block
    assert fa_ops.bwd_head_split(1, 96, 1, 10, SM_COUNT) == 10
    # the split always divides the group
    for G in range(1, 17):
        assert G % fa_ops.bwd_head_split(1, 64, 1, G, SM_COUNT) == 0
