#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card and the
CUDA toolkit (``nvcc``).  It imports nothing of JAX and nothing of the
JAX package ``repro``; it builds the port's CUDA kernels from the sources
under ``src/repro_torch/kernels/csrc`` on first use.  Phases, one line
each:

1. environment: card name and power limit, torch/CUDA versions, build time;
2. kernels: every CUDA kernel against its plain PyTorch version on the
   card (hostile paged layout, padding-row poison, single == blocked and
   fused == scatter-then-attend bitwise, the flash sweep up to Dh=256 and
   the tensor-core body's tile skipping over unsorted positions with
   empty slots, rows without a valid key and skippable windows, decode
   attention over wrapped rings with empty slots, a window and a row with
   no valid key, split over one, several and many chunks, bitwise the
   same for a row alone and in a batch of eight, the paged kernel split
   over pages with each row bitwise the same alone under its own table
   and in a batch of eight under a wider one, the RG-LRU scan bitwise
   past its tile and block edges, the shared-prefix kernel and op over
   prime and long prefixes with ragged suffixes, and the main paths'
   full-width shapes with kernel / plain / library times and the card's
   lower bound);
3. shared prefix: the Hydragen op through its entry point at qwen3-1.7b's
   attention width, B=8 and B=32 rows on one 2048-token prefix; both of
   its kernels must launch, the prefix kernel on the tensor cores (it
   merges the suffix pass itself), and in f32 it must equal today's
   engine route (the paged kernel over shared prefix pages), which is
   timed beside it, as is SDPA over the same function;
4. engine: full-width qwen3-1.7b (random weights from a seed) served by
   the continuous-batching ``InferenceEngine``: prefix sharing with a
   copy-on-write partial page, a coalesced duplicate, a request admitted
   mid-decode; the kernels' launch counters must move, every bf16 flash
   launch must take the tensor cores and every decode launch the split,
   and the plain versions must not run, and the paged decode must split
   a row's pages across blocks; the CUDA and plain decode steps must
   agree, in bf16 and, on a float32 copy of the weights, to f32 rounding;
   batch invariance in bf16 and on a float32 copy (logged: cuBLAS may
   pick its GEMM by the row count); then the same model on the
   dense-view arm (``paged_decode=False``), which decodes in the
   decode_attention kernel;
5. hybrid: full-width recurrentgemma-2b served through the engine's
   dense-row path (flash prefill at Dh=256, the RG-LRU scan, decode
   attention over the ring), its step profile and parity, batch
   invariance in bf16 and (asserted) on a float32 copy of the weights, and
   a prompt past the 2048-token window held against the teacher-forced
   forward;
6. the wall time, a ``{"kernels": [...]}`` line, the card's
   ``nvidia-smi`` line, and the last line ``{"ok": true, "device":
   {...}}``.

Any failed check raises and the script exits non-zero without the last
line.  Without a CUDA device it exits 2 before doing anything.
"""
from __future__ import annotations

import gc
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of bytes / memory rate and operations / the rate for their type
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAKS_OF = "H100 SXM (3.35 TB/s HBM3, 989 TFLOP/s bf16, 67 TFLOP/s f32)"


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_calls(torch, fn, n: int):
    """Wall ms per call (host clock around ``n`` calls ending in a
    synchronize, under the profiler), device-busy ms per call (the sum of
    the profiler's CUDA kernel intervals) and the six kernels with the
    most device time, as [name, ms per call]."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # a session now and then reports no device events: take the next one
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        per_kernel = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = e.name[:60]
                per_kernel[name] = per_kernel.get(name, 0.0) \
                    + e.time_range.elapsed_us()
        if per_kernel:
            break
    busy_us = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    return (1e3 * wall / n, busy_us / 1e3 / n,
            [[k, round(us / 1e3 / n, 4)] for k, us in top])


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ring_positions(np, qp, T):
    """(B, T) positions of a ring of T slots written up to ``qp``: slot s
    holds the newest position q <= qp with q = s (mod T), -1 if none."""
    kp = qp[:, None] - np.mod(qp[:, None] - np.arange(T)[None, :], T)
    return np.where(kp >= 0, kp, -1).astype(np.int32)


def kernels_flash_skipping(torch, t, rng, fa_ops, flash_attention_ref):
    """The tensor-core body's tile skipping against the plain version:
    permuted positions with scattered -1 slots, Sq and Skv no multiple of
    a tile, a query tile mixing rows with and without a valid key (those
    give mean(V)), and a window that leaves most KV tiles skippable."""
    import numpy as np
    dev = torch.device("cuda")

    def ints(a):
        return torch.as_tensor(np.asarray(a, np.int32)).to(dev)

    n_tc = fa_ops.tensor_core_launches
    n_calls = 0
    for (H, Hkv, Dh) in ((16, 8, 128), (10, 1, 256), (4, 2, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            tol = 2e-5 if dtype == torch.float32 else 3e-2
            # unsorted positions, empty slots, ragged Sq and Skv
            B, Sq, Skv = 2, 100, 203
            q = t(rng.normal(size=(B, Sq, H, Dh)), dtype)
            k = t(rng.normal(size=(B, Skv, Hkv, Dh)), dtype)
            v = t(rng.normal(size=(B, Skv, Hkv, Dh)), dtype)
            kp = np.stack([rng.permutation(Skv) for _ in range(B)])
            kp[rng.random(size=kp.shape) < 0.15] = -1
            qp = np.stack([np.sort(rng.choice(Skv, Sq, replace=False))
                           for _ in range(B)])
            for window in (0, 29):
                out = fa_ops.flash_attention(q, k, v, q_positions=ints(qp),
                                             kv_positions=ints(kp),
                                             window=window)
                ref = flash_attention_ref(q, k, v, q_positions=ints(qp),
                                          kv_positions=ints(kp),
                                          window=window)
                torch.testing.assert_close(out.float(), ref.float(),
                                           atol=tol, rtol=tol)
                n_calls += dtype == torch.bfloat16
            # rows without a valid key inside a tile that skips tiles
            B, Sq, Skv = 1, 130, 300
            q = t(rng.normal(size=(B, Sq, H, Dh)), dtype)
            k = t(rng.normal(size=(B, Skv, Hkv, Dh)), dtype)
            v = t(rng.normal(size=(B, Skv, Hkv, Dh)), dtype)
            qp = np.arange(Skv - Sq, Skv)[None].copy()
            qp[0, [3, 40]] = -1
            kvp = np.arange(Skv)[None]
            out = fa_ops.flash_attention(q, k, v, q_positions=ints(qp),
                                         kv_positions=ints(kvp), window=48)
            ref = flash_attention_ref(q, k, v, q_positions=ints(qp),
                                      kv_positions=ints(kvp), window=48)
            torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                       rtol=tol)
            mean_v = v[0].float().mean(0).repeat_interleave(H // Hkv, 0)
            for row in (3, 40):
                torch.testing.assert_close(out[0, row].float(), mean_v,
                                           atol=tol, rtol=tol)
            n_calls += dtype == torch.bfloat16
        # a 64-key window over 700 keys: most KV tiles skipped
        S = 700
        q = t(rng.normal(size=(1, S, H, Dh)), torch.bfloat16)
        k = t(rng.normal(size=(1, S, Hkv, Dh)), torch.bfloat16)
        v = t(rng.normal(size=(1, S, Hkv, Dh)), torch.bfloat16)
        pos = ints(np.arange(S)[None])
        out = fa_ops.flash_attention(q, k, v, q_positions=pos,
                                     kv_positions=pos, window=64)
        ref = flash_attention_ref(q, k, v, q_positions=pos,
                                  kv_positions=pos, window=64)
        torch.testing.assert_close(out.float(), ref.float(), atol=3e-2,
                                   rtol=3e-2)
        n_calls += 1
    torch.cuda.synchronize()
    assert fa_ops.tensor_core_launches - n_tc == n_calls, \
        "a bf16 call at Dh 64/128/256 missed the tensor-core body"
    log("kernels.flash_skipping", shapes="H/Hkv/Dh 16/8/128, 10/1/256, "
        "4/2/64 x f32/bf16", cases="permuted kv positions with -1 slots "
        "(Sq=100,Skv=203, window 0/29); rows 3,40 without a valid key in a "
        "skipping tile (window 48); window 64 over 700 keys",
        vs_plain="ok", no_valid_key_rows="mean(V)",
        bf16_tensor_core_launches=n_calls)


def kernels_decode(torch, F, t, rng, da_ops, decode_attention_ref,
                   lse_combine, NEG_INF):
    """The decode kernel against its plain version on hostile rings, then
    timed at the hybrid's decode shape.  Returns its kernels entry."""
    import numpy as np
    dev = torch.device("cuda")
    for (B, T, H, Hkv, Dh) in ((4, 96, 10, 1, 256), (4, 100, 16, 8, 128)):
        for dtype in (torch.float32, torch.bfloat16):
            for window in (0, 37):
                q = t(rng.normal(size=(B, H, Dh)), dtype)
                k = t(rng.normal(size=(B, T, Hkv, Dh)), dtype)
                v = t(rng.normal(size=(B, T, Hkv, Dh)), dtype)
                qp = np.asarray([2 * T + 5, T // 2, 3 * T - 1, 7])
                kp = ring_positions(np, qp, T)
                kp[-1] = -1                     # padding row: no valid key
                qp_d = torch.as_tensor(qp, dtype=torch.int32).to(dev)
                kp_d = torch.as_tensor(kp).to(dev)
                out, m, l = da_ops.decode_attention(
                    q, k, v, q_positions=qp_d, kv_positions=kp_d,
                    window=window, return_lse=True)
                ref, mr, lr = decode_attention_ref(
                    q, k, v, q_positions=qp_d, kv_positions=kp_d,
                    window=window, return_lse=True)
                tol = 2e-5 if dtype == torch.float32 else 3e-2
                torch.testing.assert_close(out.float(), ref.float(),
                                           atol=tol, rtol=tol)
                torch.testing.assert_close(m, mr, atol=2e-5, rtol=2e-5)
                torch.testing.assert_close(l, lr, atol=2e-5, rtol=2e-5)
                assert torch.all(out[-1] == 0) and torch.all(
                    m[-1] == NEG_INF) and torch.all(l[-1] == 0), "pin"
                half = T // 2
                parts = [da_ops.decode_attention(
                    q, k[:, sl].contiguous(), v[:, sl].contiguous(),
                    q_positions=qp_d, kv_positions=kp_d[:, sl].contiguous(),
                    window=window, return_lse=True)
                    for sl in (slice(0, half), slice(half, T))]
                torch.testing.assert_close(lse_combine(parts).float(),
                                           out.float(), atol=tol, rtol=tol)
    # the split: one chunk, T no multiple of the chunk, many chunks of one
    # sub-tile and (T=5000) of several; whole chunks of empty slots
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    grids = []
    for (T, H, Hkv, Dh) in ((40, 4, 2, 64), (100, 16, 8, 128),
                            (517, 10, 1, 256), (5000, 10, 1, 256)):
        chunk, n_chunks = da_ops.plan_chunks(T, Dh, n_sm)
        grids.append(f"T={T}:{n_chunks}x{chunk}")
        for dtype in (torch.float32, torch.bfloat16):
            B = 3
            q = t(rng.normal(size=(B, H, Dh)), dtype)
            k = t(rng.normal(size=(B, T, Hkv, Dh)), dtype)
            v = t(rng.normal(size=(B, T, Hkv, Dh)), dtype)
            qp = np.asarray([2 * T + 3, T // 2, 7 * T])
            kp = ring_positions(np, qp, T)
            kp[1, chunk // 2:chunk // 2 + 3 * chunk] = -1
            kp[-1] = -1
            qp_d = torch.as_tensor(qp, dtype=torch.int32).to(dev)
            kp_d = torch.as_tensor(kp).to(dev)
            s0 = da_ops.split_launches
            out, m, l = da_ops.decode_attention(
                q, k, v, q_positions=qp_d, kv_positions=kp_d,
                return_lse=True)
            assert da_ops.split_launches - s0 == (n_chunks > 1)
            ref, mr, lr = decode_attention_ref(
                q, k, v, q_positions=qp_d, kv_positions=kp_d,
                return_lse=True)
            tol = 2e-5 if dtype == torch.float32 else 3e-2
            torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                       rtol=tol)
            torch.testing.assert_close(m, mr, atol=2e-5, rtol=2e-5)
            torch.testing.assert_close(l, lr, atol=2e-5, rtol=2e-5)
            assert torch.all(out[-1] == 0) and torch.all(
                m[-1] == NEG_INF) and torch.all(l[-1] == 0), "pin"
    # the chunk plan ignores B: a row alone and in a batch of eight
    for dtype in (torch.float32, torch.bfloat16):
        B, T, H, Hkv, Dh = 8, 512, 10, 1, 256
        q = t(rng.normal(size=(B, H, Dh)), dtype)
        k = t(rng.normal(size=(B, T, Hkv, Dh)), dtype)
        v = t(rng.normal(size=(B, T, Hkv, Dh)), dtype)
        qp_d = torch.as_tensor(rng.integers(100, 3 * T, size=(B,)),
                               dtype=torch.int32).to(dev)
        kp_d = torch.as_tensor(ring_positions(np, qp_d.cpu().numpy(),
                                              T)).to(dev)
        whole = da_ops.decode_attention(q, k, v, q_positions=qp_d,
                                        kv_positions=kp_d, window=200,
                                        return_lse=True)
        one = da_ops.decode_attention(
            q[2:3].contiguous(), k[2:3].contiguous(), v[2:3].contiguous(),
            q_positions=qp_d[2:3].contiguous(),
            kv_positions=kp_d[2:3].contiguous(), window=200,
            return_lse=True)
        for a, b in zip(one, whole):
            assert torch.equal(a[0], b[2]), "decode depends on B"
    torch.cuda.synchronize()
    log("kernels.decode_attention",
        sweep="G=10/Dh=256 and G=2/Dh=128 x f32/bf16 x window 0/37",
        cases="wrapped ring, unwrapped ring with -1 slots, padding row",
        vs_plain="ok", padding_row="pinned(0,NEG_INF,0)",
        split_halves_lse_combine="ok", split_grids=",".join(grids),
        empty_chunks="ok", row_alone_vs_in_batch_of_8="bitwise")

    # the hybrid's decode step: B=8 rows over a 512-slot ring (engine
    # defaults: max_seq_len 512 under the 2048 window), bf16; sixteen
    # layers' caches are cycled (67 MB, past the 50 MB L2), as the eight
    # attention blocks of a step and the weights between them would evict
    B, T, H, Hkv, Dh, NL = 8, 512, 10, 1, 256, 16
    q = t(rng.normal(size=(B, H, Dh)), torch.bfloat16)
    ks = t(rng.normal(size=(NL, B, T, Hkv, Dh)), torch.bfloat16)
    vs = t(rng.normal(size=(NL, B, T, Hkv, Dh)), torch.bfloat16)
    qp = np.asarray(rng.integers(100, 432, size=(B,)))
    kp = ring_positions(np, qp, T)
    qp_d = torch.as_tensor(qp, dtype=torch.int32).to(dev)
    kp_d = torch.as_tensor(kp).to(dev)
    layer = [0]

    def run():
        i = layer[0] = (layer[0] + 1) % NL
        return da_ops.decode_attention(q, ks[i], vs[i], q_positions=qp_d,
                                       kv_positions=kp_d)

    def plain():
        i = layer[0] = (layer[0] + 1) % NL
        return decode_attention_ref(q, ks[i], vs[i], q_positions=qp_d,
                                    kv_positions=kp_d)

    qs = q[:, :, None, :]                                  # (B,H,1,Dh)
    kt, vt = ks.transpose(2, 3), vs.transpose(2, 3)        # (NL,B,Hkv,T,Dh)
    mask = (kp_d >= 0)[:, None, None, :]

    def library():
        i = layer[0] = (layer[0] + 1) % NL
        return F.scaled_dot_product_attention(qs, kt[i], vt[i],
                                              attn_mask=mask,
                                              enable_gqa=True)

    err = (da_ops.decode_attention(q, ks[0], vs[0], q_positions=qp_d,
                                   kv_positions=kp_d).float()
           - decode_attention_ref(q, ks[0], vs[0], q_positions=qp_d,
                                  kv_positions=kp_d).float()
           ).abs().max().item()
    assert err < 3e-2, f"decode main shape err {err}"
    # the work depends on the data: only the valid slots' K/V must be read
    valid = int((kp_d >= 0).sum().item())
    nbytes = 2 * q.numel() * 2 + 2 * valid * Hkv * Dh * 2 + 2 * B * H * 4 \
        + 4 * (kp_d.numel() + B)
    b_ms, b_by = bound(nbytes, 4 * Dh * H * valid, "bfloat16")
    entry = {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:64",
        "launches": None, "max_abs_err": err,
        "ms": time_ms(torch, run, iters=48),
        "device_ms": profile_calls(torch, run, 48)[1],
        "plain_ms": time_ms(torch, plain, iters=16),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(torch, library, iters=48)}
    log("kernels.decode_attention_main",
        shape=f"B={B},T={T},H={H},Hkv={Hkv},Dh={Dh},bf16,valid_keys={valid}",
        max_abs_err=f"{err:.3e}", tolerance=3e-2, ms=f"{entry['ms']:.4f}",
        device_ms=f"{entry['device_ms']:.4f}",
        plain_ms=f"{entry['plain_ms']:.4f}",
        library_ms=f"{entry['library_ms']:.4f}", bound_ms=f"{b_ms:.5f}",
        bound_by=b_by, bytes=nbytes)
    return entry


def kernels_scan(torch, rng, lru_ops, linear_scan_ref):
    """The RG-LRU scan bitwise against its plain version, then timed at
    the hybrid's prefill shape.  Returns its kernels entry."""
    dev = torch.device("cuda")

    def inputs(B, S, D):
        a = torch.as_tensor(rng.uniform(0.5, 1.0, size=(B, S, D)),
                            dtype=torch.float32).to(dev)
        b = torch.as_tensor(rng.normal(size=(B, S, D)),
                            dtype=torch.float32).to(dev)
        return a, b

    # S past a 64-step tile and not a multiple of it, D not a multiple of
    # a block's 32 channels (16-byte copies at 40, 4-byte ones at 70, 33, 1)
    shapes = ((2, 37, 70), (3, 5, 1), (1, 9, 2560), (2, 129, 40),
              (4, 1, 33), (2, 200, 2560))
    for shape in shapes:
        a, b = inputs(*shape)
        assert torch.equal(lru_ops.linear_scan(a, b),
                           linear_scan_ref(a, b)), shape
    B, S, D = 1, 384, 2560
    a, b = inputs(B, S, D)

    def run():
        return lru_ops.linear_scan(a, b)

    assert torch.equal(run(), linear_scan_ref(a, b)), "main shape"
    nbytes = 3 * B * S * D * 4
    b_ms, b_by = bound(nbytes, 2 * B * S * D, "float32")
    entry = {
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan/kernel.py:42",
        "launches": None, "max_abs_err": 0.0,
        "ms": time_ms(torch, run, iters=50),
        "device_ms": profile_calls(torch, run, 50)[1],
        "plain_ms": time_ms(torch, lambda: linear_scan_ref(a, b), iters=3,
                            warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "library_note": "no single PyTorch call computes "
                        "h_t = a_t*h_{t-1} + b_t"}
    log("kernels.rglru_scan", bitwise_shapes=",".join(
        str(x).replace(" ", "") for x in shapes + ((B, S, D),)),
        vs_plain="bitwise", main_shape=f"B={B},S={S},D={D},f32",
        ms=f"{entry['ms']:.4f}", device_ms=f"{entry['device_ms']:.4f}",
        plain_ms=f"{entry['plain_ms']:.4f}", bound_ms=f"{b_ms:.5f}",
        bound_by=b_by, library_ms="none (no single PyTorch call)")
    return entry


def kernels_flash_hybrid(torch, F, t, rng, fa_ops, flash_attention_ref):
    """The flash kernel at the hybrid's prefill shape (one 384-token
    prompt, MQA, Dh=256, window 2048), bf16: error, times, bound; it must
    take the tensor-core body.  Returns those numbers."""
    dev = torch.device("cuda")
    B, S, H, Hkv, Dh, window = 1, 384, 10, 1, 256, 2048
    q = t(rng.normal(size=(B, S, H, Dh)), torch.bfloat16)
    k = t(rng.normal(size=(B, S, Hkv, Dh)), torch.bfloat16)
    v = t(rng.normal(size=(B, S, Hkv, Dh)), torch.bfloat16)
    pos = torch.arange(S, dtype=torch.int32, device=dev).expand(
        B, S).contiguous()

    def run():
        return fa_ops.flash_attention(q, k, v, q_positions=pos,
                                      kv_positions=pos, window=window)

    def plain():
        return flash_attention_ref(q, k, v, q_positions=pos,
                                   kv_positions=pos, window=window)

    mask = (pos[:, None, :, None] >= pos[:, None, None, :]) \
        & (pos[:, None, None, :] > pos[:, None, :, None] - window)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)

    err = (run().float() - plain().float()).abs().max().item()
    assert err < 3e-2, f"flash hybrid shape err {err}"
    pairs = int(mask.sum().item())
    nbytes = 2 * q.numel() * 2 + 2 * k.numel() * 2 + 4 * 2 * pos.numel()
    b_ms, b_by = bound(nbytes, 4 * Dh * H * pairs, "bfloat16")
    n_tc = fa_ops.tensor_core_launches
    run()
    assert fa_ops.tensor_core_launches == n_tc + 1, \
        "Dh=256 missed the tensor cores"
    res = {"shape": f"B={B},Sq=Skv={S},H={H},Hkv={Hkv},Dh={Dh},"
                    f"window={window},bf16",
           "max_abs_err": err, "ms": time_ms(torch, run),
           "device_ms": profile_calls(torch, run, 20)[1],
           "plain_ms": time_ms(torch, plain), "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": time_ms(torch, library)}
    log("kernels.flash_hybrid", shape=res["shape"], max_abs_err=f"{err:.3e}",
        tolerance=3e-2, ms=f"{res['ms']:.4f}",
        device_ms=f"{res['device_ms']:.4f}",
        plain_ms=f"{res['plain_ms']:.4f}",
        library_ms=f"{res['library_ms']:.4f}", bound_ms=f"{b_ms:.5f}",
        bound_by=b_by, body="tensor cores")
    return res


def prefix_suffix_positions(np, P, lens, T):
    """q_positions (B,) and suffix_positions (B,T) of rows whose suffix
    holds ``lens[b]`` tokens at positions P.. after the shared prefix."""
    sp = np.where(np.arange(T)[None, :] < lens[:, None],
                  P + np.arange(T)[None, :], -1).astype(np.int32)
    return (P + lens - 1).astype(np.int32), sp


# The shared-prefix limits, set from the readings on an H100 (PERF.md
# section 6).  The kernel and its plain version both compute in f32 from
# the same inputs in either dtype, so (acc, m, l) keep f32's limit in
# bf16: the sweep read at most 2.9e-5 in acc and 2.7e-4 in l, where they
# are large, and 5.7e-6 in acc at qwen3's width.  The op's bf16 output
# differs only where its f32 value rounds to bf16 the other way (read at
# most 2.4e-4): 2e-3 plus one bf16 ulp (8e-3 relative).
KERNEL_TOL = {"atol": 2e-5, "rtol": 2e-5}


def op_tol(torch, dtype):
    if dtype == torch.float32:
        return {"atol": 2e-5, "rtol": 2e-5}
    return {"atol": 2e-3, "rtol": 8e-3}


def kernels_shared_prefix(torch, t, rng, sp_ops, prefix_attention_ref,
                          shared_prefix_attention_ref, NEG_INF):
    """The prefix kernel and the op against their plain versions on the
    card: f32/bf16, three head layouts, P prime, odd and long, ragged
    suffixes, a row whose suffix is all -1 and a query before the
    prefix's end (the op's contract: the prefix stays visible)."""
    import numpy as np
    dev = torch.device("cuda")
    errs = {}
    B, T = 5, 70
    for (H, Hkv, Dh) in ((16, 8, 128), (10, 1, 256), (4, 2, 64)):
        for P in (37, 131, 2048):
            for dtype in (torch.float32, torch.bfloat16):
                q = t(rng.normal(size=(B, H, Dh)), dtype)
                pk = t(rng.normal(size=(P, Hkv, Dh)), dtype)
                pv = t(rng.normal(size=(P, Hkv, Dh)), dtype)
                sk = t(rng.normal(size=(B, T, Hkv, Dh)), dtype)
                sv = t(rng.normal(size=(B, T, Hkv, Dh)), dtype)
                lens = rng.integers(1, T + 1, size=(B,))
                lens[0], lens[-2] = T, 0           # full, all -1
                qp, sp = prefix_suffix_positions(np, P, lens, T)
                qp[-1] = P // 3                    # before the prefix end
                qp_d = torch.as_tensor(qp).to(dev)
                sp_d = torch.as_tensor(sp).to(dev)
                pos = torch.arange(P, dtype=torch.int32, device=dev)
                got = sp_ops.prefix_attention(q, pk, pv, pos)
                want = prefix_attention_ref(q, pk, pv, pos)
                for name, a, b in zip(("acc", "m", "l"), got, want):
                    torch.testing.assert_close(a, b, **KERNEL_TOL)
                    errs[name] = max(errs.get(name, 0.0),
                                     (a - b).abs().max().item())
                out = sp_ops.shared_prefix_attention(
                    q, pk, pv, sk, sv, q_positions=qp_d,
                    suffix_positions=sp_d)
                ref = shared_prefix_attention_ref(
                    q, pk, pv, sk, sv, q_positions=qp_d,
                    suffix_positions=sp_d)
                torch.testing.assert_close(out.float(), ref.float(),
                                           **op_tol(torch, dtype))
                errs["op"] = max(errs.get("op", 0.0), (
                    out.float() - ref.float()).abs().max().item())
        # a prefix with no valid key pins every row
        acc, m, l = sp_ops.prefix_attention(
            q, pk, pv, torch.full((P,), -1, dtype=torch.int32, device=dev))
        assert torch.all(acc == 0) and torch.all(m == NEG_INF) \
            and torch.all(l == 0), "empty prefix not pinned"
    torch.cuda.synchronize()
    log("kernels.shared_prefix",
        sweep="(H,Hkv,Dh)=(16,8,128),(10,1,256),(4,2,64) x P=37,131,2048 x "
        "f32/bf16", cases="ragged suffixes, an all -1 suffix row, "
        "q_position<P-1, empty prefix pinned",
        tolerance="(acc,m,l) 2e-5 atol+rtol; op f32 2e-5, bf16 2e-3 atol "
        "+ 8e-3 rtol",
        max_abs_err_acc=f"{errs['acc']:.3e}", max_abs_err_m=f"{errs['m']:.3e}",
        max_abs_err_l=f"{errs['l']:.3e}", max_abs_err_op=f"{errs['op']:.3e}")


def shared_prefix_full(torch, F, np, sp_ops, da_ops, pd_ops,
                       prefix_attention_ref, shared_prefix_attention_ref):
    """The slice's path, the op through its public entry point at
    qwen3-1.7b's attention width (H=16, Hkv=8, Dh=128), bf16: B=8 and B=32
    rows share one 2048-token prefix, each with a 512-slot suffix of 64 to
    512 valid tokens.  Eight layers' inputs are cycled (past the 50 MB
    L2).  Beside it, today's engine route: the paged decode kernel over
    pages (page 8) where every row's page table starts with the same
    prefix pages.  Returns the prefix kernel's kernels entry (B=8)."""
    dev = torch.device("cuda")
    H, Hkv, Dh, P, T, ps, NL = 16, 8, 128, 2048, 512, 8, 8
    gen = torch.Generator(device=dev).manual_seed(13)
    lens_rng = np.random.default_rng(13)
    entry = None
    for B in (8, 32):
        # one pool per layer holds the prefix pages, then each row's own
        # suffix pages; the op reads the same bytes as contiguous views
        n_pages = (P + B * T) // ps
        pools = torch.randn((2, NL, n_pages, ps, Hkv, Dh), generator=gen,
                            device=dev, dtype=torch.bfloat16)
        pk = [pools[0, i, :P // ps].view(P, Hkv, Dh) for i in range(NL)]
        pv = [pools[1, i, :P // ps].view(P, Hkv, Dh) for i in range(NL)]
        sk = [pools[0, i, P // ps:].view(B, T, Hkv, Dh) for i in range(NL)]
        sv = [pools[1, i, P // ps:].view(B, T, Hkv, Dh) for i in range(NL)]
        q = torch.randn((B, H, Dh), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        lens = lens_rng.integers(64, T + 1, size=(B,))
        qp, sp = prefix_suffix_positions(np, P, lens, T)
        qp_d = torch.as_tensor(qp).to(dev)
        sp_d = torch.as_tensor(sp).to(dev)
        pos = torch.arange(P, dtype=torch.int32, device=dev)
        pt = np.concatenate([np.broadcast_to(np.arange(P // ps), (B, P // ps)),
                             P // ps + np.arange(B * T // ps).reshape(B, -1)],
                            axis=1).astype(np.int32)
        pt_d = torch.as_tensor(pt).to(dev)

        # the main path: one call of the op; both kernels must launch, the
        # prefix kernel on the tensor cores (it merges the suffix itself)
        sp_ops.reset_counts()
        da_ops.reset_counts()
        out = sp_ops.shared_prefix_attention(
            q, pk[0], pv[0], sk[0], sv[0], q_positions=qp_d,
            suffix_positions=sp_d)
        torch.cuda.synchronize()
        n_sp, n_da = sp_ops.launches, da_ops.launches
        n_tc, n_cc = sp_ops.tensor_core_launches, sp_ops.cuda_core_launches
        assert (n_sp, n_da) == (1, 1), (n_sp, n_da)
        assert (n_tc, n_cc) == (1, 0), ("bf16 prefix launch off the tensor "
                                        "cores", n_tc, n_cc)
        assert out.shape == (B, H, Dh) and bool(torch.isfinite(out).all())
        ref = shared_prefix_attention_ref(q, pk[0], pv[0], sk[0], sv[0],
                                          q_positions=qp_d,
                                          suffix_positions=sp_d)
        op_err = (out.float() - ref.float()).abs().max().item()
        torch.testing.assert_close(out.float(), ref.float(),
                                   **op_tol(torch, torch.bfloat16))
        got = sp_ops.prefix_attention(q, pk[0], pv[0], pos)
        want = prefix_attention_ref(q, pk[0], pv[0], pos)
        k_errs = [(a - b).abs().max().item() for a, b in zip(got, want)]
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **KERNEL_TOL)

        # the same data in f32: the op against the paged route
        p32 = pools[:, 0].float()
        out32 = sp_ops.shared_prefix_attention(
            q.float(), p32[0, :P // ps].view(P, Hkv, Dh),
            p32[1, :P // ps].view(P, Hkv, Dh),
            p32[0, P // ps:].view(B, T, Hkv, Dh),
            p32[1, P // ps:].view(B, T, Hkv, Dh), q_positions=qp_d,
            suffix_positions=sp_d)
        paged32 = pd_ops.paged_decode_attention(q.float(), p32[0], p32[1],
                                                pt_d, qp_d, variant="blocked")
        paged_diff = (out32 - paged32).abs().max().item()
        assert paged_diff <= 2e-5, f"op vs paged route in f32: {paged_diff}"
        del p32, out32, paged32

        layer = [0]

        def cyc():
            layer[0] = (layer[0] + 1) % NL
            return layer[0]

        def prefix_run():
            i = cyc()
            return sp_ops.prefix_attention(q, pk[i], pv[i], pos)

        def prefix_plain():
            i = cyc()
            return prefix_attention_ref(q, pk[i], pv[i], pos)

        def op_run():
            i = cyc()
            return sp_ops.shared_prefix_attention(
                q, pk[i], pv[i], sk[i], sv[i], q_positions=qp_d,
                suffix_positions=sp_d)

        def op_plain():
            i = cyc()
            return shared_prefix_attention_ref(
                q, pk[i], pv[i], sk[i], sv[i], q_positions=qp_d,
                suffix_positions=sp_d)

        times = {"prefix_kernel": time_ms(torch, prefix_run, iters=48),
                 "op": time_ms(torch, op_run, iters=48),
                 "prefix_plain": time_ms(torch, prefix_plain, iters=8),
                 "op_plain": time_ms(torch, op_plain, iters=8)}
        # back-to-back calls can be bound by the wrappers' host time; the
        # profiler's kernel intervals give the card's own time per call
        device_ms, top = {}, {}
        for what, fn in (("prefix_kernel", prefix_run), ("op", op_run)):
            _, device_ms[what], top[what] = profile_calls(torch, fn, 16)
        # the library yardstick: SDPA over the prefix broadcast to every
        # row and concatenated with the suffix, a boolean mask
        kcat = [torch.cat([pk[i].expand(B, P, Hkv, Dh), sk[i]], 1)
                .transpose(1, 2).contiguous() for i in range(NL)]
        vcat = [torch.cat([pv[i].expand(B, P, Hkv, Dh), sv[i]], 1)
                .transpose(1, 2).contiguous() for i in range(NL)]
        mask = torch.cat([torch.ones((B, P), dtype=torch.bool, device=dev),
                          sp_d >= 0], 1)[:, None, None, :]
        qs = q[:, :, None, :]

        def library(i=None):
            i = cyc() if i is None else i
            return F.scaled_dot_product_attention(qs, kcat[i], vcat[i],
                                                  attn_mask=mask,
                                                  enable_gqa=True)

        lib_err = (library(0)[:, :, 0].float() - ref.float()).abs().max()
        times["library"] = time_ms(torch, library, iters=48)
        device_ms["library"] = profile_calls(torch, library, 16)[1]
        del kcat, vcat
        # today's engine route over the same values: the paged kernel
        # (attend only, 4 pages per block) over an f32 pool, as the engine
        # keeps it, and over a bf16 pool, the op's bytes per element
        pools32 = pools.float()

        def paged(pk_, pv_):
            def run():
                i = cyc()
                return pd_ops.paged_decode_attention(
                    q, pk_[i], pv_[i], pt_d, qp_d, variant="blocked")
            return run

        times["paged_f32_pool"] = time_ms(torch, paged(pools32[0],
                                                       pools32[1]), iters=24)
        device_ms["paged_f32_pool"] = profile_calls(
            torch, paged(pools32[0], pools32[1]), 16)[1]
        times["paged_bf16_pool"] = time_ms(torch, paged(pools[0], pools[1]),
                                           iters=24)
        del pools32
        # bound: the prefix K/V read once, q, positions, the partial out
        nbytes = 2 * P * Hkv * Dh * 2 + q.numel() * 2 + 4 * P \
            + B * H * (Dh + 2) * 4
        flops = 4 * B * H * P * Dh
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        cuda_core_ms = flops / PEAK_FLOPS["float32"] * 1e3
        log("kernels.shared_prefix.full",
            shape=f"B={B},P={P},T={T},H={H},Hkv={Hkv},Dh={Dh},bf16",
            suffix_lens=f"{int(lens.min())}..{int(lens.max())}",
            prefix_launches=n_sp, decode_attention_launches=n_da,
            prefix_tensor_core_launches=n_tc, prefix_cuda_core_launches=n_cc,
            op_max_abs_err=f"{op_err:.3e}",
            kernel_max_abs_err_acc_m_l=json.dumps(
                [float(f"{e:.3e}") for e in k_errs]),
            f32_op_vs_paged_route=f"{paged_diff:.3e}", f32_tolerance=2e-5,
            sdpa_err=f"{lib_err.item():.3e}",
            **{f"{k}_ms": f"{v:.4f}" for k, v in times.items()},
            **{f"{k}_device_ms": f"{v:.4f}" for k, v in device_ms.items()},
            op_top_kernels_ms_per_call=json.dumps(top["op"]),
            prefix_top_kernels_ms_per_call=json.dumps(top["prefix_kernel"]),
            bound_ms=f"{b_ms:.5f}", bound_by=b_by, bytes=nbytes,
            flops=flops, f32_cuda_core_ms=f"{cuda_core_ms:.5f}")
        if B == 8:
            entry = {
                "name": "shared_prefix_attention", "route": "cuda",
                "source":
                    "src/repro_torch/kernels/csrc/shared_prefix_attention.cu",
                "replaces":
                    "src/repro/kernels/shared_prefix_attention/kernel.py:65",
                "launches": None, "tensor_core_launches": 0,
                "cuda_core_launches": 0, "max_abs_err": k_errs[0],
                "ms": times["prefix_kernel"],
                "device_ms": device_ms["prefix_kernel"],
                "plain_ms": times["prefix_plain"],
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": times["library"],
                "library_device_ms": device_ms["library"],
                "library_note": "SDPA over the broadcast [prefix; suffix], "
                                "the whole op's function: set it against "
                                "op_ms and op_device_ms",
                "op_ms": times["op"], "op_device_ms": device_ms["op"],
                "plain_op_ms": times["op_plain"],
                "paged_route_ms": times["paged_f32_pool"],
                "paged_route_device_ms": device_ms["paged_f32_pool"]}
        else:
            entry["b32"] = {
                "ms": times["prefix_kernel"],
                "device_ms": device_ms["prefix_kernel"],
                "bound_ms": b_ms, "max_abs_err": k_errs[0],
                "op_ms": times["op"], "op_device_ms": device_ms["op"],
                "library_ms": times["library"],
                "library_device_ms": device_ms["library"]}
        entry["launches"] = (entry["launches"] or 0) + n_sp
        entry["tensor_core_launches"] += n_tc
        entry["cuda_core_launches"] += n_cc
        del pools, pk, pv, sk, sv
        torch.cuda.empty_cache()
    return entry


def first_difference(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def engine_dense_view(torch, np, eng, prompts, outs, max_new, da_ops,
                      pd_ops, InferenceEngine):
    """qwen3-1.7b on the engine's dense-view arm (``paged_decode=False``):
    rows gathered from the pages into a dense view, decode_step in the
    decode_attention kernel, each step's K/V appended back to the pages.
    Held against the paged run of the same weights."""
    dev = torch.device("cuda")
    cfg = eng.cfg
    dv = InferenceEngine(cfg, seed=0, paged_decode=False)
    dv.load(eng.model.state_dict())
    step_s = []
    orig = dv._decode_once

    def timed_decode():
        t0 = time.perf_counter()
        orig()
        step_s.append(time.perf_counter() - t0)

    dv._decode_once = timed_decode
    names = ("cold_c", "cold_d", "share_a")
    da_ops.reset_counts()
    pd_ops.launches = 0
    handles = {n: dv.submit(prompts[n], max_new_tokens=max_new)
               for n in names}
    res = {n: h.result(timeout=600) for n, h in handles.items()}
    dv.drain()              # the last step's timer appends after results
    torch.cuda.synchronize()
    da_n, pd_n = da_ops.launches, pd_ops.launches
    da_split = da_ops.split_launches
    n_steps = len(step_s)
    assert all(len(r) == max_new for r in res.values()), "short output"
    assert pd_n == 0 and n_steps > 0 \
        and da_n == cfg.num_layers * n_steps, (da_n, pd_n, n_steps)
    assert da_split == da_n, "a dense-view decode launch was not split"
    dv._decode_once = orig
    log("engine.dense_view", model="qwen3-1.7b(full width, 28 layers)",
        paged_decode=False, requests=len(names), decode_steps=n_steps,
        decode_attention_launches=da_n, split_launches=da_split,
        launches_per_step=f"{da_n / n_steps:.1f}", paged_launches=pd_n,
        view_rebuilds=dv.stats.view_rebuilds,
        mean_step_ms=f"{1e3 * sum(step_s) / n_steps:.3f}",
        tokens_equal_paged=json.dumps({n: res[n] == outs[n] for n in names}),
        first_differing_token=json.dumps(
            {n: first_difference(res[n], outs[n]) for n in names}))

    # one step over the same pages: the dense view (decode kernel) against
    # the paged step (paged kernel), bf16 activations through 28 layers
    model, kv = dv.model, dv.kv
    seqs = list(dv._warm)[:3]
    lens = [kv.sequences[s].length for s in seqs]
    layers_, heads, dh = dv._paged_layout
    k_rows = torch.zeros((3, layers_, dv._round_t(max(lens) + 1), heads, dh),
                         dtype=model.dtype, device=dev)
    v_rows = torch.zeros_like(k_rows)
    for i, s in enumerate(seqs):
        kr, vr = kv.gather(s)
        k_rows[i, :, :lens[i]] = kr
        v_rows[i, :, :lens[i]] = vr
    tok = torch.tensor([11, 12, 13], dtype=torch.int32, device=dev)
    dense, _ = model.decode_step(tok, model.paged_cache_view(k_rows, v_rows,
                                                             lens))
    kv.prepare_appends(seqs)
    n_pages = max(len(kv.sequences[s].page_ids) for s in seqs)
    pt = np.zeros((3, n_pages), np.int32)
    for i, s in enumerate(seqs):
        pt[i, :len(kv.sequences[s].page_ids)] = kv.sequences[s].page_ids
    paged, _, _ = model.paged_decode_step(
        tok, kv.k.clone(), kv.v.clone(), torch.as_tensor(pt).to(dev),
        torch.tensor(lens, dtype=torch.int32, device=dev))
    diff = (dense.float() - paged.float()).abs().max().item()
    scale = paged.float().abs().max().item()
    assert bool(torch.isfinite(dense).all()) and diff <= 5e-2 * scale, \
        (diff, scale)
    log("engine.dense_view_parity", rows=3, max_abs_diff=f"{diff:.4e}",
        logit_scale=f"{scale:.4e}", tolerance="5e-2*scale",
        same_argmax=torch.equal(dense.argmax(-1), paged.argmax(-1)))
    dv.shutdown()


def hybrid_phases(torch, np, get_config, tokenizer, InferenceEngine, fa_ops,
                  da_ops, lru_ops, pd_ops, plain_calls):
    """Full-width recurrentgemma-2b through the engine's dense-row path,
    then its step profile, parity, batch invariance and the ring past the
    window.  Returns the launches of its main path, by kernel."""
    dev = torch.device("cuda")
    cfg = get_config("recurrentgemma-2b")
    eng = InferenceEngine(cfg, seed=0)
    torch.cuda.reset_peak_memory_stats()
    load_s = eng.load()
    n_params = sum(p.numel() for p in eng.model.parameters())
    words = np.random.default_rng(5)

    def text(n):
        return " ".join(f"w{int(x)}" for x in words.integers(0, 10**6, n))

    vocab = cfg.vocab_size
    prompts = {"a": tokenizer.tokenize(text(379), vocab),
               "b": tokenizer.tokenize(text(149), vocab),
               "c": tokenizer.tokenize(text(229), vocab),
               "d": tokenizer.tokenize(text(99), vocab),
               "late_e": tokenizer.tokenize(text(301), vocab)}
    assert all(100 <= len(p) <= 400 for p in prompts.values())
    max_new = 32

    step_s, admit_s = [], []
    orig_decode, orig_admit = eng._decode_once, eng._admit_one

    def timed_decode():
        t0 = time.perf_counter()
        orig_decode()
        step_s.append(time.perf_counter() - t0)

    def timed_admit(req):
        t0 = time.perf_counter()
        slot = orig_admit(req)
        admit_s.append(time.perf_counter() - t0)
        return slot

    def serve(eng):
        """Four requests and a duplicate, then one more after the first
        decode step: up to five live rows."""
        handles = {n: eng.submit(prompts[n], max_new_tokens=max_new)
                   for n in ("a", "b", "c", "d")}
        handles["dup_a"] = eng.submit(prompts["a"], max_new_tokens=max_new)
        deadline = time.monotonic() + 300
        while eng.stats.decode_tokens < 1:
            assert time.monotonic() < deadline, "engine made no decode step"
            time.sleep(0.001)
        handles["late_e"] = eng.submit(prompts["late_e"],
                                       max_new_tokens=max_new)
        outs = {n: h.result(timeout=600) for n, h in handles.items()}
        eng.drain()         # the last step's timer appends after results
        return outs

    eng._decode_once, eng._admit_one = timed_decode, timed_admit
    fa_ops.reset_counts()
    da_ops.reset_counts()
    lru_ops.launches = 0
    pd_ops.launches = 0
    plain0 = plain_calls["n"]
    t_run = time.perf_counter()
    outs = serve(eng)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = {"flash_attention": fa_ops.launches,
                "flash_tensor_core": fa_ops.tensor_core_launches,
                "decode_attention": da_ops.launches,
                "decode_split": da_ops.split_launches,
                "rglru_scan": lru_ops.launches,
                "paged_decode_attention": pd_ops.launches}
    eng._decode_once, eng._admit_one = orig_decode, orig_admit
    st = eng.stats
    assert all(len(o) == max_new for o in outs.values()), "short output"
    assert outs["dup_a"] == outs["a"]
    assert st.coalesced_requests >= 1 and st.peak_batch >= 2, st.as_dict()
    assert launches["flash_attention"] > 0 \
        and launches["decode_attention"] > 0 \
        and launches["rglru_scan"] > 0 \
        and launches["paged_decode_attention"] == 0, launches
    assert launches["flash_tensor_core"] == launches["flash_attention"], \
        "a bf16 flash launch missed the tensor cores"
    assert launches["decode_split"] == launches["decode_attention"], \
        "a decode launch was not split"
    assert plain_calls["n"] == plain0, "a plain version ran on the CUDA path"
    assert eng.kv is None, "the dense-row path allocated pages"
    n_steps, admitted = len(step_s), len(admit_s)
    log("hybrid.run", model="recurrentgemma-2b(full width, 26 blocks)",
        params=n_params, requests=len(outs), admitted=admitted,
        tokens_each=max_new, coalesced=st.coalesced_requests,
        peak_batch=st.peak_batch, admission_waves=st.admission_waves,
        view_rebuilds=st.view_rebuilds, decode_steps=n_steps,
        decode_tokens=st.decode_tokens, kv_pages="none",
        load_s=f"{load_s:.3f}", run_s=f"{run_s:.3f}")
    decode_s = sum(step_s)
    log("hybrid.perf", decode_tok_per_s=f"{st.decode_tokens / decode_s:.2f}",
        mean_step_ms=f"{1e3 * decode_s / n_steps:.3f}",
        prefill_ms_per_request=f"{1e3 * sum(admit_s) / admitted:.3f}",
        launches=json.dumps(launches),
        decode_attention_per_step=
        f"{launches['decode_attention'] / n_steps:.1f}",
        flash_per_request=f"{launches['flash_attention'] / admitted:.1f}",
        rglru_scan_per_request=f"{launches['rglru_scan'] / admitted:.1f}",
        max_memory_allocated_gib=
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
        plain_calls=plain_calls["n"] - plain0)

    # a B=8 decode view of one prefilled 380-token row, and one prefill
    model = eng.model
    toks_a = torch.as_tensor([prompts["a"]], dtype=torch.int32, device=dev)
    _, cache = model.prefill(toks_a)
    row = model.extend_cache(cache, eng.max_seq_len - toks_a.shape[1])
    axes = model.cache_batch_axes(row)
    view = {k: torch.cat([row[k]] * 8, dim=ax) for k, ax in axes.items()}
    tok8 = torch.arange(8, dtype=torch.int32, device=dev) + 11

    def decode_step():
        model.decode_step(tok8, view)

    def prefill():
        model.prefill(toks_a)

    for what, fn, n in (("decode_step(B=8,T=512)", decode_step, 5),
                        ("prefill(S=380)", prefill, 2)):
        wall_ms, busy_ms, top = profile_calls(torch, fn, n)
        log("hybrid.profile", call=what, calls=n,
            wall_ms_per_call=f"{wall_ms:.3f}",
            device_busy_ms_per_call=f"{busy_ms:.3f}",
            device_busy_share=f"{busy_ms / wall_ms:.3f}",
            top_kernels_ms_per_call=json.dumps(top))

    # one decode step under impl="cuda" and under impl="torch" on copies
    # of the same view
    logits = {}
    for impl in ("cuda", "torch"):
        lg, _ = model.decode_step(tok8, {k: v.clone() for k, v in
                                         view.items()}, impl=impl)
        assert lg.shape == (8, cfg.padded_vocab) and bool(
            torch.isfinite(lg).all()), impl
        logits[impl] = lg.float()
    diff = (logits["cuda"] - logits["torch"]).abs().max().item()
    scale = logits["torch"].abs().max().item()
    assert diff <= 5e-2 * scale, (diff, scale)
    log("hybrid.step_parity", rows=8, max_abs_diff=f"{diff:.4e}",
        logit_scale=f"{scale:.4e}", tolerance="5e-2*scale",
        same_argmax=torch.equal(logits["cuda"].argmax(-1),
                                logits["torch"].argmax(-1)))
    del view, row, cache

    # batch invariance: the first request, decoded again alone; then the
    # same on a float32 copy of the weights, where other GEMM shapes at
    # B=1 and at B=8 differ by f32 rounding only, so a token that differs
    # there is a fault of the port, not bf16 rounding on flat logits
    alone = eng.generate([prompts["a"]], max_new_tokens=max_new)[0]
    log("hybrid.batch_invariance", request="a", batched_vs_alone=
        "equal" if alone == outs["a"] else "differ",
        first_differing_token=first_difference(alone, outs["a"]))
    eng.shutdown()
    e32 = InferenceEngine(cfg.replace(dtype="float32"), seed=0)
    e32.load(model.state_dict())                       # bf16 -> f32, exact
    outs32 = serve(e32)
    alone32 = e32.generate([prompts["a"]], max_new_tokens=max_new)[0]
    assert all(len(o) == max_new for o in outs32.values()), "short output"
    log("hybrid.batch_invariance", dtype="float32", request="a",
        peak_batch=e32.stats.peak_batch, batched_vs_alone=
        "equal" if alone32 == outs32["a"] else "differ",
        first_differing_token=first_difference(alone32, outs32["a"]),
        tokens_equal_bf16_run=json.dumps(
            {n: outs32[n] == outs[n] for n in outs}))
    assert alone32 == outs32["a"], "float32 tokens depend on the batch"
    e32.shutdown()
    hybrid_ring(torch, model, e32.model, words, vocab)
    e32.unload()
    return launches


def hybrid_ring(torch, model, m32, words, vocab):
    """Prefill 2100 tokens (past the 2048 window, 2100 % 2048 != 0), then
    decode 8 under "cuda": the logits must follow the teacher-forced
    forward, which needs position p in ring slot p % 2048.  Run on a
    float32 copy of the weights, where the two paths differ by rounding
    only (in bf16 their rounding differs by a few percent of the logit
    scale on random weights, which would hide a misplaced ring); as a
    control, the same decode from the ring placed as the JAX reference
    places it (slots 0..T-1).  ``m32`` is the float32 copy of ``model``."""
    dev = torch.device("cuda")
    S, n_dec = 2100, 8
    T = model.cfg.local_attn_window
    toks = torch.as_tensor(words.integers(1, vocab, S + n_dec),
                           dtype=torch.int32, device=dev)[None]
    full, _ = m32(toks, impl="cuda")
    ref = full[0, S - 1:].clone()
    del full
    logits, cache = m32.prefill(toks[:, :S], impl="cuda")
    assert cache["g2_k"].shape[2] == T
    misplaced = {k: (torch.roll(v, -(S % T), dims=2)
                     if k.endswith("_k") or k.endswith("_v") else v.clone())
                 for k, v in cache.items()}

    def decode(cache):
        got = [logits[0]]
        for i in range(n_dec):
            lg, cache = m32.decode_step(toks[:, S + i], cache, impl="cuda")
            got.append(lg[0])
        return torch.stack(got)

    got, control = decode(cache), decode(misplaced)
    diff = (got - ref).abs().max().item()
    ctrl = (control - ref).abs().max().item()
    scale = ref.abs().max().item()
    # f32 rounding leaves about 1.5e-5 of the scale; the misplaced ring
    # about 1.3e-2 of it.  The limit sits between, and the control must
    # fail it, or the check could not see a misplaced ring.
    limit = 1e-3 * scale
    assert bool(torch.isfinite(got).all()) and diff <= limit, (diff, scale)
    assert ctrl > limit, (ctrl, scale)
    log("hybrid.ring", dtype="float32", prompt=S, window=T,
        ring_offset=S % T, decoded=n_dec, positions_checked=n_dec + 1,
        max_abs_diff=f"{diff:.4e}", logit_scale=f"{scale:.4e}",
        tolerance="1e-3*scale",
        same_argmax=torch.equal(got.argmax(-1), ref.argmax(-1)),
        control_slots_0_to_T_max_abs_diff=f"{ctrl:.4e}")


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.engine import tokenizer
    from repro_torch.engine.engine import InferenceEngine
    from repro_torch.engine.models import build_model, layers, rglru
    from repro_torch.kernels import build
    from repro_torch.kernels.common import NEG_INF
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, lse_combine)
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_decode_attention import ops as pd_ops
    from repro_torch.kernels.paged_decode_attention.ref import (
        fused_paged_decode_attention_ref, paged_decode_attention_ref,
        scatter_append_ref)
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.kernels.rglru_scan.ref import linear_scan_ref
    from repro_torch.kernels.shared_prefix_attention import ops as sp_ops
    from repro_torch.kernels.shared_prefix_attention.ref import (
        prefix_attention_ref, shared_prefix_attention_ref)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi_line()

    # ------------------------------------------------------ 1. environment
    t0 = time.perf_counter()
    build.library()
    log("env", card=json.dumps(smi), torch=torch.__version__,
        cuda=torch.version.cuda, build_s=f"{build.build_seconds:.3f}",
        load_s=f"{time.perf_counter() - t0:.3f}")

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev, dtype)

    # ---------------------------------------------------------- 2. kernels
    # hostile paged layout: shuffled pool, rows 0/1 alias their first two
    # pages, lengths ending mid-page, one padding row
    rng = np.random.default_rng(11)
    B, NP, ps, H, Hkv, Dh = 3, 5, 8, 4, 2, 16
    P = 2 * B * NP
    pt = np.asarray(rng.permutation(P)[:B * NP].reshape(B, NP), np.int32)
    pt[1, :2] = pt[0, :2]
    lens = np.asarray(rng.integers(2 * ps + 1, NP * ps - 2, size=(B,)),
                      np.int32)
    lens = np.where(lens % ps == 0, lens + 1, lens)
    lens[-1] = -1
    pt_d = torch.as_tensor(pt).to(dev)
    lens_d = torch.as_tensor(lens).to(dev)
    for q_dt, pool_dt in ((torch.float32, torch.float32),
                          (torch.bfloat16, torch.float32),
                          (torch.bfloat16, torch.bfloat16)):
        q = t(rng.normal(size=(B, H, Dh)), q_dt)
        kp = t(rng.normal(size=(P, ps, Hkv, Dh)), pool_dt)
        vp = t(rng.normal(size=(P, ps, Hkv, Dh)), pool_dt)
        k_new = t(rng.normal(size=(B, Hkv, Dh)), pool_dt)
        v_new = t(rng.normal(size=(B, Hkv, Dh)), pool_dt)
        single, m, l = pd_ops.paged_decode_attention(
            q, kp, vp, pt_d, lens_d, variant="single", return_lse=True)
        ref, mr, lr = paged_decode_attention_ref(q, kp, vp, pt_d, lens_d,
                                                 return_lse=True)
        tol = 2e-5 if q_dt == torch.float32 else 3e-2
        torch.testing.assert_close(single.float(), ref.float(), atol=tol,
                                   rtol=tol)
        torch.testing.assert_close(m, mr, atol=2e-5, rtol=2e-5)
        torch.testing.assert_close(l, lr, atol=2e-5, rtol=2e-5)
        assert torch.all(single[-1] == 0) and torch.all(m[-1] == NEG_INF) \
            and torch.all(l[-1] == 0), "padding row not pinned"
        for ppb in (2, 3, 4, 8):
            blocked = pd_ops.paged_decode_attention(
                q, kp, vp, pt_d, lens_d, variant="blocked",
                pages_per_block=ppb)
            assert torch.equal(blocked, single), f"blocked ppb={ppb}"
        for ppb in (1, 2, 3, 4):
            ks, vs = scatter_append_ref(kp.clone(), vp.clone(), pt_d,
                                        lens_d, k_new, v_new)
            base = pd_ops.paged_decode_attention(
                q, ks, vs, pt_d, lens_d, variant="blocked",
                pages_per_block=ppb)
            kf, vf = kp.clone(), vp.clone()
            fused, _, _ = pd_ops.fused_paged_decode_attention(
                q, kf, vf, pt_d, lens_d, k_new, v_new, pages_per_block=ppb)
            assert torch.equal(fused, base), f"fused out ppb={ppb}"
            assert torch.equal(kf, ks) and torch.equal(vf, vs), \
                f"fused pools ppb={ppb}"
        # poison: the padding row's new KV must not reach the pool
        kf, vf = kp.clone(), vp.clone()
        pd_ops.fused_paged_decode_attention(
            q, kf, vf, pt_d, lens_d, torch.full_like(k_new, 1e6),
            torch.full_like(v_new, -1e6), pages_per_block=2)
        for pg in pt[-1]:
            assert not torch.any(kf[int(pg)] == 1e6) \
                and not torch.any(vf[int(pg)] == -1e6), "padding row wrote"
        torch.cuda.synchronize()
    log("kernels.paged", layout="hostile(B=3,NP=5,ps=8,H=4,Hkv=2,Dh=16)",
        dtypes="f32/f32,bf16/f32,bf16/bf16", single_vs_plain="ok",
        blocked_eq_single="bitwise", fused_eq_scatter_attend="bitwise",
        padding_row="pinned,writes_nothing")

    for (B, Sq, Skv, H, Hkv, Dh) in ((1, 32, 32, 2, 2, 8),
                                     (2, 64, 64, 4, 2, 16),
                                     (2, 16, 64, 8, 1, 32),
                                     (1, 40, 72, 10, 1, 256)):
        for dtype in (torch.float32, torch.bfloat16):
            for window in (0, 24):
                q = t(rng.normal(size=(B, Sq, H, Dh)), dtype)
                k = t(rng.normal(size=(B, Skv, Hkv, Dh)), dtype)
                v = t(rng.normal(size=(B, Skv, Hkv, Dh)), dtype)
                qp = torch.arange(Skv - Sq, Skv, dtype=torch.int32,
                                  device=dev).expand(B, Sq).contiguous()
                kvp = torch.arange(Skv, dtype=torch.int32,
                                   device=dev).expand(B, Skv).contiguous()
                qp[0, 0] = -1                  # no valid key: mean(V)
                out = fa_ops.flash_attention(q, k, v, q_positions=qp,
                                             kv_positions=kvp,
                                             window=window)
                ref = flash_attention_ref(q, k, v, q_positions=qp,
                                          kv_positions=kvp, window=window)
                tol = 2e-5 if dtype == torch.float32 else 3e-2
                torch.testing.assert_close(out.float(), ref.float(),
                                           atol=tol, rtol=tol)
                mean_v = v[0].float().mean(0).repeat_interleave(H // Hkv, 0)
                torch.testing.assert_close(out[0, 0].float(), mean_v,
                                           atol=tol, rtol=tol)
    torch.cuda.synchronize()
    kernels_flash_skipping(torch, t, rng, fa_ops, flash_attention_ref)
    log("kernels.flash", sweep="4 shapes (Dh 8..256, MQA H=10 at Dh=256) x "
        "f32/bf16 x window 0/24",
        vs_plain="ok", no_valid_key_row="mean(V)")

    kernels = []
    # flash at the engine's prefill shape: a 512-token chunk after a
    # 32-token cached prefix, bf16
    B, Sq, Skv, H, Hkv, Dh = 1, 512, 544, 16, 8, 128
    q = t(rng.normal(size=(B, Sq, H, Dh)), torch.bfloat16)
    k = t(rng.normal(size=(B, Skv, Hkv, Dh)), torch.bfloat16)
    v = t(rng.normal(size=(B, Skv, Hkv, Dh)), torch.bfloat16)
    qp = torch.arange(Skv - Sq, Skv, dtype=torch.int32,
                      device=dev).expand(B, Sq).contiguous()
    kvp = torch.arange(Skv, dtype=torch.int32, device=dev).expand(
        B, Skv).contiguous()

    def flash_run():
        return fa_ops.flash_attention(q, k, v, q_positions=qp,
                                      kv_positions=kvp)

    def flash_plain():
        return flash_attention_ref(q, k, v, q_positions=qp,
                                   kv_positions=kvp)

    mask = (kvp[:, None, None, :] <= qp[:, None, :, None])   # (B,1,Sq,Skv)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def flash_library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)

    n_tc = fa_ops.tensor_core_launches
    err = (flash_run().float() - flash_plain().float()).abs().max().item()
    assert err < 3e-2, f"flash main shape err {err}"
    assert fa_ops.tensor_core_launches == n_tc + 1, "missed the tensor cores"
    lib_err = (flash_library().transpose(1, 2).float()
               - flash_plain().float()).abs().max().item()
    pairs = int(mask.sum().item())
    fl_bytes = 2 * (q.numel() * 2) + 2 * (k.numel() * 2) \
        + 4 * (qp.numel() + kvp.numel())
    fl_bound, fl_by = bound(fl_bytes, 4 * Dh * H * pairs, "bfloat16")
    fa_ms = time_ms(torch, flash_run)
    fa_dev = profile_calls(torch, flash_run, 20)[1]
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:76",
        "launches": None, "max_abs_err": err, "ms": fa_ms,
        "device_ms": fa_dev, "plain_ms": time_ms(torch, flash_plain),
        "bound_ms": fl_bound, "bound_by": fl_by,
        "library_ms": time_ms(torch, flash_library)})
    log("kernels.flash_main", shape=f"B={B},Sq={Sq},Skv={Skv},H={H},"
        f"Hkv={Hkv},Dh={Dh},bf16", max_abs_err=f"{err:.3e}", tolerance=3e-2,
        sdpa_err=f"{lib_err:.3e}", ms=f"{fa_ms:.4f}",
        device_ms=f"{fa_dev:.4f}",
        plain_ms=f"{kernels[-1]['plain_ms']:.4f}",
        library_ms=f"{kernels[-1]['library_ms']:.4f}",
        bound_ms=f"{fl_bound:.5f}", bound_by=fl_by, body="tensor cores")

    # fused paged decode at the engine's full-width decode step: B=8 rows
    # of 65 live pages, page 8, f32 pool, bf16 q; four layers' pools are
    # cycled so each launch finds its pages out of L2, as a step does
    B, NP, ps, H, Hkv, Dh, NL = 8, 65, 8, 16, 8, 128, 4
    P = 1024
    q = t(rng.normal(size=(B, H, Dh)), torch.bfloat16)
    pools = [t(rng.normal(size=(NL, P, ps, Hkv, Dh)), torch.bfloat16).float()
             for _ in range(2)]
    pt_d = torch.as_tensor(rng.permutation(P)[:B * NP].reshape(B, NP),
                           dtype=torch.int32).to(dev)
    lens_d = torch.full((B,), NP * ps - 3, dtype=torch.int32, device=dev)
    k_new = t(rng.normal(size=(B, Hkv, Dh)), torch.bfloat16).float()
    v_new = t(rng.normal(size=(B, Hkv, Dh)), torch.bfloat16).float()
    ks, vs = scatter_append_ref(pools[0][0].clone(), pools[1][0].clone(),
                                pt_d, lens_d, k_new, v_new)
    ref = paged_decode_attention_ref(q, ks, vs, pt_d, lens_d)
    out, k0, _ = pd_ops.fused_paged_decode_attention(
        q, pools[0][0], pools[1][0], pt_d, lens_d, k_new, v_new)
    pd_err = (out.float() - ref.float()).abs().max().item()
    assert pd_err < 3e-2 and torch.equal(k0, ks), f"paged main err {pd_err}"
    layer = [0]

    def pd_run():
        i = layer[0] = (layer[0] + 1) % NL
        return pd_ops.fused_paged_decode_attention(
            q, pools[0][i], pools[1][i], pt_d, lens_d, k_new, v_new)

    def pd_plain():
        i = layer[0] = (layer[0] + 1) % NL
        return fused_paged_decode_attention_ref(
            q, pools[0][i], pools[1][i], pt_d, lens_d, k_new, v_new)

    T = NP * ps
    kd = pools[0][0][pt_d.long()].reshape(B, T, Hkv, Dh).transpose(1, 2)
    vd = pools[1][0][pt_d.long()].reshape(B, T, Hkv, Dh).transpose(1, 2)
    qd = q.float()[:, :, None, :]
    dmask = (torch.arange(T, device=dev)[None, :]
             <= lens_d[:, None])[:, None, None, :]

    def pd_library():
        return F.scaled_dot_product_attention(qd, kd, vd, attn_mask=dmask,
                                              enable_gqa=True)

    # the split's chunk plan ignores B and the table's width: rows of
    # several lengths, alone under their own tables and together under a
    # table wider than every row, give the same bits
    chunk = pd_ops.plan_chunk_pages(ps, Dh)
    chunks_per_row = [pd_ops.row_chunks(int(n), ps, NP, chunk)
                      for n in lens_d.tolist()]
    var_lens = [NP * ps - 3, 2, chunk * ps, chunk * ps - 1, 20 * ps + 1,
                -1, 3 * chunk * ps + 5, 40 * ps + 7]
    wide = torch.as_tensor(rng.permutation(P)[:B * (NP + 7)].reshape(
        B, NP + 7), dtype=torch.int32).to(dev)
    var_d = torch.as_tensor(var_lens, dtype=torch.int32, device=dev)
    s0 = pd_ops.split_launches
    batch = pd_ops.paged_decode_attention(q, pools[0][1], pools[1][1], wide,
                                          var_d, return_lse=True)
    for i, n in enumerate(var_lens):
        own = max(1, n // ps + 1)
        one = pd_ops.paged_decode_attention(
            q[i:i + 1].contiguous(), pools[0][1], pools[1][1],
            wide[i:i + 1, :own].contiguous(), var_d[i:i + 1].contiguous(),
            return_lse=True)
        assert all(torch.equal(a[0], b[i]) for a, b in zip(one, batch)), \
            f"paged row {i} depends on its batch"
    assert pd_ops.split_launches > s0, "the wide table was not split"
    live = int(B * NP)                   # distinct live pages, all rows
    pd_bytes = live * ps * Hkv * Dh * 4 * 2 + q.numel() * 2 * 2 \
        + 2 * B * H * 4 + 4 * (pt_d.numel() + B) + 2 * k_new.numel() * 4 * 2
    valid_tokens = int((lens_d + 1).sum().item())
    pd_bound, pd_by = bound(pd_bytes, 4 * H * Dh * valid_tokens, "float32")
    pd_ms = time_ms(torch, pd_run, iters=40)
    pd_dev, pd_top = profile_calls(torch, pd_run, 40)[1:]
    kernels.append({
        "name": "paged_decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
        "replaces":
            "src/repro/kernels/paged_decode_attention/kernel.py:375",
        "launches": None, "max_abs_err": pd_err, "ms": pd_ms,
        "device_ms": pd_dev, "plain_ms": time_ms(torch, pd_plain),
        "bound_ms": pd_bound, "bound_by": pd_by,
        "library_ms": time_ms(torch, pd_library),
        "chunk_pages": chunk})
    log("kernels.paged_main", shape=f"fused,B={B},live_pages={NP},ps={ps},"
        f"Hkv={Hkv},Dh={Dh},G={H // Hkv},q=bf16,pool=f32",
        max_abs_err=f"{pd_err:.3e}", tolerance=3e-2, ms=f"{pd_ms:.4f}",
        device_ms=f"{pd_dev:.4f}", top_kernels_ms_per_call=json.dumps(pd_top),
        plain_ms=f"{kernels[-1]['plain_ms']:.4f}",
        library_ms=f"{kernels[-1]['library_ms']:.4f}",
        bound_ms=f"{pd_bound:.5f}", bound_by=pd_by,
        bytes=pd_bytes, peaks=json.dumps(PEAKS_OF), chunk_pages=chunk,
        chunks_per_row=json.dumps(chunks_per_row),
        row_alone_vs_in_batch_of_8_wider_table="bitwise")

    # the attend-only arms (kernel_variant="single"/"blocked") on the same
    # inputs; the plain version is the gather-dense reference
    def arm(variant):
        def run():
            i = layer[0] = (layer[0] + 1) % NL
            return pd_ops.paged_decode_attention(
                q, pools[0][i], pools[1][i], pt_d, lens_d, variant=variant)
        return run

    def arm_plain():
        i = layer[0] = (layer[0] + 1) % NL
        return paged_decode_attention_ref(q, pools[0][i], pools[1][i], pt_d,
                                          lens_d)

    log("kernels.paged_arms", shape="as paged_main, attend only",
        single_ms=f"{time_ms(torch, arm('single'), iters=40):.4f}",
        blocked_ppb4_ms=f"{time_ms(torch, arm('blocked'), iters=40):.4f}",
        plain_ms=f"{time_ms(torch, arm_plain):.4f}")
    del pools, kd, vd, ks, vs
    torch.cuda.empty_cache()

    kernels.append(kernels_decode(torch, F, t, rng, da_ops,
                                  decode_attention_ref, lse_combine, NEG_INF))
    kernels.append(kernels_scan(torch, rng, lru_ops, linear_scan_ref))
    kernels[0]["dh256"] = kernels_flash_hybrid(torch, F, t, rng, fa_ops,
                                               flash_attention_ref)
    kernels_shared_prefix(torch, t, rng, sp_ops, prefix_attention_ref,
                          shared_prefix_attention_ref, NEG_INF)
    torch.cuda.empty_cache()

    # ----------------------------------------------------- 3. shared prefix
    kernels.append(shared_prefix_full(torch, F, np, sp_ops, da_ops, pd_ops,
                                      prefix_attention_ref,
                                      shared_prefix_attention_ref))

    # ----------------------------------------------------------- 4. engine
    cfg = get_config("qwen3-1.7b")
    eng = InferenceEngine(cfg, seed=0)
    torch.cuda.reset_peak_memory_stats()
    load_s = eng.load()
    words = np.random.default_rng(3)

    def text(n):
        return " ".join(f"w{int(x)}" for x in words.integers(0, 10**6, n))

    vocab = cfg.vocab_size
    shared = tokenizer.tokenize(text(130), vocab)        # 131 tokens
    prompts = {
        "share_a": shared + tokenizer.tokenize(text(70), vocab, False),
        "share_b": shared + tokenizer.tokenize(text(120), vocab, False),
        "cold_c": tokenizer.tokenize(text(379), vocab),
        "cold_d": tokenizer.tokenize(text(149), vocab),
        "late_e": shared + tokenizer.tokenize(text(40), vocab, False),
    }
    assert all(100 <= len(p) <= 400 for p in prompts.values())
    assert len(shared) % eng.page_size != 0
    max_new = 32

    # count the plain versions: none may run on the CUDA path
    plain_calls = {"n": 0}

    def counted(fn):
        def wrapper(*a, **kw):
            plain_calls["n"] += 1
            return fn(*a, **kw)
        return wrapper

    fa_ops.flash_attention_ref = counted(fa_ops.flash_attention_ref)
    layers.flash_attention_ref = counted(layers.flash_attention_ref)
    pd_ops.paged_decode_attention_ref = counted(
        pd_ops.paged_decode_attention_ref)
    pd_ops.fused_paged_decode_attention_ref = counted(
        pd_ops.fused_paged_decode_attention_ref)
    da_ops.decode_attention_ref = counted(da_ops.decode_attention_ref)
    lru_ops.linear_scan_ref = counted(lru_ops.linear_scan_ref)
    rglru.linear_scan_ref = counted(rglru.linear_scan_ref)

    step_s, admit_s = [], []
    orig_decode, orig_admit = eng._decode_paged, eng._admit_one

    def timed_decode():
        t0 = time.perf_counter()
        orig_decode()
        step_s.append(time.perf_counter() - t0)

    def timed_admit(req):
        t0 = time.perf_counter()
        slot = orig_admit(req)
        admit_s.append(time.perf_counter() - t0)
        return slot

    eng._decode_paged, eng._admit_one = timed_decode, timed_admit

    def serve(eng):
        """Four requests and a duplicate, then one more after the first
        decode step."""
        handles = {n: eng.submit(prompts[n], max_new_tokens=max_new)
                   for n in ("cold_c", "share_a", "share_b", "cold_d")}
        handles["dup_c"] = eng.submit(prompts["cold_c"],
                                      max_new_tokens=max_new)
        deadline = time.monotonic() + 300
        while eng.stats.decode_tokens < 1:
            assert time.monotonic() < deadline, "engine made no decode step"
            time.sleep(0.001)
        handles["late_e"] = eng.submit(prompts["late_e"],
                                       max_new_tokens=max_new)
        outs = {n: h.result(timeout=600) for n, h in handles.items()}
        eng.drain()         # the last step's timer appends after results
        return outs

    fa_ops.reset_counts()
    pd_ops.reset_counts()
    t_run = time.perf_counter()
    outs = serve(eng)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    fa_launches, pd_launches = fa_ops.launches, pd_ops.launches
    pd_split = pd_ops.split_launches
    kernels[0]["launches"] = fa_launches
    kernels[0]["tensor_core_launches"] = fa_ops.tensor_core_launches
    kernels[1]["launches"] = pd_launches
    kernels[1]["split_launches"] = pd_split
    st = eng.stats
    assert all(len(o) == max_new for o in outs.values()), "short output"
    assert outs["dup_c"] == outs["cold_c"]
    assert st.prefix_hits >= 1 and st.coalesced_requests >= 1 \
        and st.peak_batch >= 2, st.as_dict()
    assert fa_launches > 0 and pd_launches > 0, (fa_launches, pd_launches)
    assert fa_ops.tensor_core_launches == fa_launches, \
        "a bf16 flash launch missed the tensor cores"
    assert pd_split > 0, "no paged decode launch was split"
    assert plain_calls["n"] == 0, "a plain version ran on the CUDA path"
    n_steps = len(step_s)
    admitted = len(admit_s)
    log("engine.run", model="qwen3-1.7b(full width, 28 layers)",
        requests=len(outs), admitted=admitted, tokens_each=max_new,
        prefix_hits=st.prefix_hits, tokens_reused=st.tokens_reused,
        coalesced=st.coalesced_requests, peak_batch=st.peak_batch,
        admission_waves=st.admission_waves, decode_steps=n_steps,
        decode_tokens=st.decode_tokens, load_s=f"{load_s:.3f}",
        run_s=f"{run_s:.3f}")
    decode_s = sum(step_s)
    log("engine.perf", decode_tok_per_s=f"{st.decode_tokens / decode_s:.2f}",
        mean_step_ms=f"{1e3 * decode_s / n_steps:.3f}",
        prefill_ms_per_request=f"{1e3 * sum(admit_s) / admitted:.3f}",
        flash_launches=fa_launches,
        flash_tensor_core_launches=fa_ops.tensor_core_launches,
        flash_launches_per_request=f"{fa_launches / admitted:.1f}",
        paged_launches=pd_launches, paged_split_launches=pd_split,
        paged_launches_per_step=f"{pd_launches / n_steps:.1f}",
        max_memory_allocated_gib=
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
        plain_calls=plain_calls["n"])

    # one decode step under impl="cuda" and under impl="torch" over
    # copies of the same pool: bf16 activations through 28 layers, the
    # plain path rounding probs to bf16 before PV
    eng._decode_paged, eng._admit_one = orig_decode, orig_admit
    kv = eng.kv
    seqs = list(eng._warm)[:4]
    kv.prepare_appends(seqs)
    n_pages = max(len(kv.sequences[s].page_ids) for s in seqs)
    pt_np = np.zeros((4, n_pages), np.int32)
    for i, s in enumerate(seqs):
        pt_np[i, :len(kv.sequences[s].page_ids)] = kv.sequences[s].page_ids
    lens_step = torch.tensor([kv.sequences[s].length for s in seqs],
                             dtype=torch.int32, device=dev)
    tok_step = torch.tensor([11, 12, 13, 14], dtype=torch.int32, device=dev)
    pt_step = torch.as_tensor(pt_np).to(dev)
    logits = {}
    for impl in ("cuda", "torch"):
        lg, _, _ = eng.model.paged_decode_step(
            tok_step, kv.k.clone(), kv.v.clone(), pt_step, lens_step,
            impl=impl)
        assert lg.shape == (4, cfg.padded_vocab) and bool(
            torch.isfinite(lg).all()), impl
        logits[impl] = lg.float()
    diff = (logits["cuda"] - logits["torch"]).abs().max().item()
    scale = logits["torch"].abs().max().item()
    same_argmax = torch.equal(logits["cuda"].argmax(-1),
                              logits["torch"].argmax(-1))
    assert diff <= 5e-2 * scale, (diff, scale)
    log("engine.step_parity", rows=4, max_abs_diff=f"{diff:.4e}",
        logit_scale=f"{scale:.4e}", tolerance="5e-2*scale",
        same_argmax=same_argmax)
    # the same step on a float32 copy of the weights: what is left of the
    # difference past f32 rounding is a fault, not bf16 rounding
    m32 = build_model(cfg.replace(dtype="float32"), device=dev)
    m32.load_state_dict(eng.model.state_dict())        # bf16 -> f32, exact
    logits = {}
    for impl in ("cuda", "torch"):
        lg, _, _ = m32.paged_decode_step(
            tok_step, kv.k.clone(), kv.v.clone(), pt_step, lens_step,
            impl=impl)
        assert bool(torch.isfinite(lg).all()), impl
        logits[impl] = lg
    del m32
    diff = (logits["cuda"] - logits["torch"]).abs().max().item()
    scale = logits["torch"].abs().max().item()
    assert diff <= 1e-3 * scale, (diff, scale)
    log("engine.step_parity", dtype="float32", rows=4,
        max_abs_diff=f"{diff:.4e}", logit_scale=f"{scale:.4e}",
        tolerance="1e-3*scale", same_argmax=torch.equal(
            logits["cuda"].argmax(-1), logits["torch"].argmax(-1)))
    del logits

    # where a step's time goes: the profiler's device kernels over a few
    # decode steps (the 5 warm rows padded to 8, as the engine pads) and
    # over one 384-token cold chunk prefill
    seqs = list(eng._warm)[:8]
    kv.prepare_appends(seqs)
    n_pages = max(len(kv.sequences[s].page_ids) for s in seqs)
    pt_np = np.zeros((8, n_pages), np.int32)
    lens_np = np.full((8,), -1, np.int32)
    for i, s in enumerate(seqs):
        ids = kv.sequences[s].page_ids
        pt_np[i, :len(ids)] = ids
        lens_np[i] = kv.sequences[s].length
    pt_step = torch.as_tensor(pt_np).to(dev)
    lens_step = torch.as_tensor(lens_np).to(dev)
    tok_step = torch.arange(8, dtype=torch.int32, device=dev) + 11

    def decode_step():
        eng.model.paged_decode_step(tok_step, kv.k, kv.v, pt_step,
                                    lens_step)

    cold = prompts["cold_c"]                     # 380 tokens, padded to 384
    chunk = torch.as_tensor([cold + [0] * (384 - len(cold))],
                            dtype=torch.int32, device=dev)

    def prefill_chunk():
        eng.model.prefill_with_cache(
            chunk, eng._chunk_view(416),
            valid_len=torch.tensor([len(cold)], dtype=torch.int32,
                                   device=dev))

    for what, fn, n in (("decode_step(B=8)", decode_step, 5),
                        ("chunk_prefill(S=384,T=416)", prefill_chunk, 2)):
        wall_ms, busy_ms, top = profile_calls(torch, fn, n)
        log("engine.profile", call=what, calls=n,
            wall_ms_per_call=f"{wall_ms:.3f}",
            device_busy_ms_per_call=f"{busy_ms:.3f}",
            device_busy_share=f"{busy_ms / wall_ms:.3f}",
            top_kernels_ms_per_call=json.dumps(top))

    # batch invariance: the request decoded first in a batch of up to six
    # rows, decoded again alone (cold prefill, batch of one)
    eng.release_warm()
    alone = eng.generate([prompts["cold_c"]], max_new_tokens=max_new)[0]
    log("engine.batch_invariance", request="cold_c", batched_vs_alone=
        "equal" if alone == outs["cold_c"] else "differ",
        first_differing_token=first_difference(alone, outs["cold_c"]))
    # the same on a float32 copy of the weights: the attention kernels'
    # bits do not depend on the batch, but cuBLAS may pick its GEMM by the
    # batch's row count, so the result is logged, not asserted
    e32 = InferenceEngine(cfg.replace(dtype="float32"), seed=0)
    e32.load(eng.model.state_dict())                   # bf16 -> f32, exact
    outs32 = serve(e32)
    alone32 = e32.generate([prompts["cold_c"]], max_new_tokens=max_new)[0]
    assert all(len(o) == max_new for o in outs32.values()), "short output"
    log("engine.batch_invariance", dtype="float32", request="cold_c",
        peak_batch=e32.stats.peak_batch, batched_vs_alone=
        "equal" if alone32 == outs32["cold_c"] else "differ",
        first_differing_token=first_difference(alone32, outs32["cold_c"]),
        tokens_equal_bf16_run=json.dumps(
            {n: outs32[n] == outs[n] for n in outs}))
    e32.shutdown()
    e32.unload()
    del e32
    gc.collect()
    torch.cuda.empty_cache()
    eng.shutdown()

    engine_dense_view(torch, np, eng, prompts, outs, max_new, da_ops,
                      pd_ops, InferenceEngine)
    # free qwen3's weights and pool before the hybrid loads
    eng.unload()
    del eng, kv, orig_decode, orig_admit
    gc.collect()
    torch.cuda.empty_cache()

    # ----------------------------------------------------------- 5. hybrid
    hyb = hybrid_phases(torch, np, get_config, tokenizer, InferenceEngine,
                        fa_ops, da_ops, lru_ops, pd_ops, plain_calls)
    kernels[2]["launches"] = hyb["decode_attention"]
    kernels[2]["split_launches"] = hyb["decode_split"]
    kernels[3]["launches"] = hyb["rglru_scan"]

    # ------------------------------------------------------- 6. the report
    log("done", wall_s=f"{time.perf_counter() - t_start:.3f}",
        build_s=f"{build.build_seconds:.3f}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
