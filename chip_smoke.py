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
   prime and long prefixes with ragged suffixes, the main paths'
   full-width shapes with kernel / plain / library times and the card's
   lower bound, the paged kernel and flash at the head groupings of
   the MoE and dense-family models, G = 1 with 16 KV heads, 3, 4, 8
   (deepseek-67b) and 6 (mixtral-8x22b), flash at mixtral's 4500-token
   prefill under its 4096 window and the decode kernel over its wrapped
   4096-slot ring, flash non-causal at whisper's encoder and
   cross-attention shapes, and
   the decode kernel as whisper's decode cross-attention through the
   attention dispatcher, with its rows of no frame at 0, each held
   element by element and in RMS to the reference's scale, with
   controls that must fail);
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
   decode_attention kernel; then the paged kernel's per-shape table
   (``[kernels.paged_table]``): its provenance against this card and
   power limit (printed), each key's winner, the built-in default and
   every distinct candidate of the sweep re-timed as the sweep times
   them (the winner at most 1.25 x the best), and the engine's decode
   with no variant given, which must launch the table's variant only
   and give the greedy tokens of an engine pinned to another variant;
   every engine phase's paged launches must be the table's variant;
   every engine run is profiled, and the paged kernels the card ran,
   counted by name from the profiler's device events, must equal the
   launches the counts credit (a replayed decode graph's are credited
   as its capture counted them: the profiler shows they ran); then one
   request served through the decode step's CUDA graphs and again with
   the eager step, whose tokens must be equal and whose graphs' arm
   must run one paged kernel a layer a step (``[engine.decode_graphs]``:
   host ms a step of each, the graphs' counters and their memory pool);
5. hybrid: full-width recurrentgemma-2b served through the engine's
   dense-row path (flash prefill at Dh=256, the RG-LRU scan, decode
   attention over the ring), its step profile and parity, batch
   invariance in bf16 and (asserted) on a float32 copy of the weights, and
   a prompt past the 2048-token window held against the teacher-forced
   forward;
6. processor: Halo's batched workflows (``w5``, TPC-H, 8 queries, 2
   workers, ``decode_cap`` 16) through ``RealProcessor.run`` over
   engines of full-width qwen3-1.7b under the three model names, planned
   on the H100 profile, with a checkpoint: every (query, node) result,
   a model switch, every bf16 flash launch on the tensor cores, the
   paged split where a table passes one chunk, no plain version; the
   time in decode steps, admissions and switches, and the device's busy
   share under the profiler; a resume from the checkpoint that
   recomputes nothing; the results against coalescing off and
   pipelining off (bf16 logged, a float32 copy of the weights asserted);
   a warm prefix of worker 0 migrated to worker 1's engine and served
   there (float32, equal to a cold run); a ``ProcessorSession`` with a
   second batch grafted while the first decodes;
7. the MoE family: full-width deepseek-moe-16b in bf16 (a dense lead
   layer, then 27 layers of 64 routed experts top-6 and 2 shared) serving
   the engine phase's six requests through flash prefill and the fused
   paged decode, with each prefill chunk's and decode step's capacity and
   routed slots dropped; its profile; the CUDA step against the plain
   step in bf16 (logged, with the router's top-k selections that differ)
   and on a float32 copy cut to 4 layers (asserted); batch invariance
   (bf16 and the float32 copy); a prompt cold and over a shared prefix on
   the float32 copy, logged: the reference's capacity is per prefill
   chunk, so their tokens need not agree;
8. the rest of the dense family: full-width qwen3-8b (G=4, untied head),
   llama3.2-3b (G=3) and deepseek-67b (G=8, cut to 40 of its 95
   layers), four requests each, the launch checks, CUDA against plain
   step parity in bf16, and on a float32 copy cut to 4 layers the paged
   path's tokens equal to the dense view's;
9. sliding-window attention: full-width mixtral-8x22b cut to 12 of its
   56 layers (8 experts top-2, window 4096) on the dense-row path, six
   requests, two of them past the window at a length no multiple of it:
   flash prefill, the decode kernel over each row's ring, launch counts;
   its profile; CUDA against plain step parity (bf16 where no router
   choice flipped, and float32); on float32 copies cut to 3 layers the
   kernels' greedy tokens equal to the plain versions', and a ring past
   the window equal to the teacher-forced forward, with the JAX
   reference's ring placement and a ring of the first 4096 positions as
   controls that must fail;
10. the last single-card families, each engine freed before the next
   loads: full-width internvl2-2b (four requests with 256 patch
   embeddings, two text-only ones sharing a prefix; flash prefill, the
   fused paged decode, every paged launch split; its profile; CUDA
   against plain step parity in bf16 and float32 on a live step of all
   six rows, the patch rows among them; paged == dense view on
   a float32 copy cut to 4 layers), xlstm-350m through the dense-row path
   (six requests of 64-256 tokens, no attention kernel; its profile;
   prefill plus decode against the teacher-forced forward and batch
   invariance, float32 asserted) and whisper-tiny through the dense-row
   path (six requests with 1500 to 300 frames in one batch: flash for the
   encoder, self- and cross-attention, decode for both, launch counts
   asserted; its profile; step parity; batch invariance of the 300-frame
   request, float32 asserted);
11. latent attention: the latent decode kernel against its plain version
   at the dsv2.halo_nodes cell's shapes (768 rows of 128 heads over the
   576/512 latent, pages of 8, contexts up to 608, a padding row at 0,
   each row's last key dropped as the control that must fail), timed
   beside the plain version, with its bound; then DeepSeek-V2 as that
   cell's card holds it (full width, 30 of 60 layers, experts 0-19 of
   160) served through the engine (a shared prefix, cold prompts, a
   request admitted mid-decode) with the launch counts reset just
   before: one flash launch a layer a prefill call on the tensor cores,
   one latent kernel a layer a decode step (counted by the profiler,
   replayed graphs' included, and equal to the launches credited), the
   model's counters, no paged launch and no plain version;
12. distribution (``repro_torch.distribution``): the sharded decode at
   deepseek-67b's attention width (64 query and 8 KV heads of 128, bf16,
   B=8 over T=32768 slots), with and without a 4096-key window, over a
   one-rank NCCL group (bitwise the unsharded kernel) and over four
   processes sharing the card in a gloo group whose collectives take
   CUDA tensors, each launching the decode kernel on its 8192 slots,
   held to the unsharded kernel and the plain version (``bf16_agreement``)
   with rows whose keys end in the first shard, a window across shards
   and rows with no key anywhere (0), a dropped rank's keys as the
   control that must fail; the compressed all-reduce on the same ranks
   (one qwen3-1.7b layer of gradients each, at scales 0.01 to 300):
   within one shared quantization step of the mean, two steps of error
   feedback below twice one step's error, the JAX recipe (each rank's
   own scale, the sum dequantized by the largest) as the control that
   must fail;
13. training, each model freed before the next: the flash backward
   (``[kernels.flash_bwd]``) at qwen3's, the hybrid's (also with a
   128-key window) and whisper's encoder and cross-attention shapes, f32
   and bf16 against its plain version, the forward's log-sum-exp, a row
   with no valid key, a control that drops a dV tile, two calls bitwise
   equal, every bf16 shape on the tensor cores; the scan backward
   (``[kernels.scan_bwd]``, one kernel a call) against autograd through
   the plain scan, bitwise;
   full-width qwen3-1.7b through ``train_loop`` (``[train.qwen3]``: bf16,
   B=8, S=512, remat, 20 steps; the loss must fall; 28 forward, 28
   recompute and 28 backward flash launches a step, the forward ones on
   the tensor cores; no plain version; its profile);
   ``[train.grad_parity]`` (kernels against plain versions on a float32
   copy cut to 4 layers, a control that drops dK); ``[train.checkpoint]``
   (a resume at step 10 against the continuous run, a control with the
   moments lost; ``[distribution.checkpoint]``: the saved state loaded
   with placements on a one-rank mesh, bitwise the plain load);
   ``[train.hybrid]`` (recurrentgemma-2b, 3 steps, the
   flash and scan backward counted, every flash backward on the tensor
   cores; ``.profile`` one step) and ``[train.audio]`` (whisper-tiny,
   3 steps over 1500 frames: causal, non-causal and cross backward);
14. the roofline on the card (``[roofline.card]``): qwen3-1.7b's paged
   decode step (B=8, in the variant the table names, which its line
   prints) and chunk prefill, timed in 4., and
   ``[train.qwen3]``'s step, each counted by the port's op-cost counter
   (``repro_torch.launch.op_cost``) on meta tensors at its shapes as the
   card runs it (the hand kernels charge their own traffic): the bound
   (FLOPs at 989 TFLOP/s, bytes at 3.35 TB/s) must not pass the
   measured device-busy time, and the FLOPs
   must fall in a band of ``model_flops`` (``ROOFLINE_BANDS``); the
   share bound / measured, and the dry run's per-device bytes for the
   train step beside the card's peak (logged);
15. the dry run (``[dryrun.sweep]``, ``repro_torch.launch.dryrun``, no
   card: meta tensors over a fake process group) over all ten archs and
   four shapes on the 16 x 16 mesh and the 2 x 16 x 16 mesh, in seven
   processes started after the last timed phase: no cell may fail,
   every 16 x 16 cell must report, the skipped cells must be the seven
   full-attention archs at long_500k; each cell's roofline row, the
   2 x 16 x 16 cells done in the budget (``SWEEP_BUDGET_S``), the
   sweep's seconds;
16. the wall time (and each section's seconds, ``[phase]``, as it ends),
   a ``{"kernels": [...]}`` line (the paged kernel's
   single and blocked arms as entries of their own; the two backward
   kernels last), the card's ``nvidia-smi`` line, and the last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero without the last
line.  Without a CUDA device it exits 2 before doing anything.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import pathlib
import re
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense), the port's one source of them
# (repro_torch/configs/base.py, read by launch/roofline.py): the bound of
# a kernel is the larger of bytes / memory rate and operations / the rate
# for their type
from repro_torch.configs.base import HBM_BW as PEAK_BYTES_PER_S  # noqa: E402
from repro_torch.launch.roofline import (PEAK_FLOPS,  # noqa: E402
                                         kernel_time_bound)

PEAKS_OF = "H100 SXM (3.35 TB/s HBM3, 989 TFLOP/s bf16, 67 TFLOP/s f32)"


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


class PhaseClock:
    """Each section's seconds, ``[phase] name=... s=... total_s=...``, the
    total counted from the script's start."""

    def __init__(self, t_start: float):
        self.t0 = self.t = t_start

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        log("phase", name=name, s=f"{now - self.t:.3f}",
            total_s=f"{now - self.t0:.3f}")
        self.t = now


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def card_setup(torch, np):
    """What a run of these phases sets up first, here and in ``tools/``:
    TF32 off, the kernels built from the sources (``build.library``), and
    each kernel's plain version, where the port's modules call it, counted
    in the returned ``{"n": calls}`` so that a phase can assert none ran
    on its CUDA path.  Returns (``t``, which puts an array on the card in
    a dtype, that count)."""
    from repro_torch.engine.models import layers, rglru
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.latent_decode_attention import ops as ld_ops
    from repro_torch.kernels.paged_decode_attention import ops as pd_ops
    from repro_torch.kernels.rglru_scan import ops as lru_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    build.library()
    plain_calls = {"n": 0}

    def counted(fn):
        def wrapper(*a, **kw):
            plain_calls["n"] += 1
            return fn(*a, **kw)
        return wrapper

    for mod, name in ((fa_ops, "flash_attention_ref"),
                      (layers, "flash_attention_ref"),
                      (pd_ops, "paged_decode_attention_ref"),
                      (pd_ops, "fused_paged_decode_attention_ref"),
                      (da_ops, "decode_attention_ref"),
                      (ld_ops, "latent_decode_attention_ref"),
                      (lru_ops, "linear_scan_ref"),
                      (rglru, "linear_scan_ref"),
                      # the backward's (the training phases)
                      (fa_ops, "flash_attention_bwd_ref"),
                      (fa_ops, "flash_attention_lse_ref"),
                      (lru_ops, "linear_scan_bwd_ref")):
        setattr(mod, name, counted(getattr(mod, name)))

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev, dtype)

    return t, plain_calls


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


def queued_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)
    queued behind a sleep kernel: the host has queued every call before
    the first runs, so no host gap enters, as it does in ``time_ms`` when
    a call's host work outlasts its device work."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
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
    most device time, as [name, ms per call].  Where the profiler reports
    no device event in three sessions, device-busy ms is the CUDA events'
    time around the same calls, the list of kernels is empty, and a line
    on stderr says so."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # a session now and then reports no device events: take the next one
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            start.record()
            for _ in range(n):
                fn()
            end.record()
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
    else:
        print("chip_smoke: the profiler reported no device event; device "
              "ms from CUDA events", file=sys.stderr, flush=True)
        return 1e3 * wall / n, start.elapsed_time(end) / n, []
    busy_us = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    return (1e3 * wall / n, busy_us / 1e3 / n,
            [[k, round(us / 1e3 / n, 4)] for k, us in top])


def graph_nodes(torch, fn):
    """The work one call of ``fn`` puts on the card, read without the
    profiler: ``fn`` is captured into a CUDA graph and the graph's nodes
    (kernels, copies, memsets) are listed from its DOT dump, each as the
    first 200 characters of its label."""
    fn()
    torch.cuda.synchronize()
    # kept, not instantiated: the dump reads the captured graph
    g = torch.cuda.CUDAGraph(keep_graph=True)
    g.enable_debug_mode()
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "graph.dot"
        g.debug_dump(str(path))
        dot = path.read_text()
    del g
    # a node's statement opens its line with its quoted name and "[";
    # an edge's has "->" after the name
    heads = list(re.finditer(r'^"graph_\d+_node_\d+"\s*\[', dot, re.M))
    return [" ".join(dot[h.end():nxt].split())[:200]
            for h, nxt in zip(heads, [h.start() for h in heads[1:]]
                              + [len(dot)])]


PAGED_KERNEL = "paged_split_kernel"
LATENT_KERNEL = "latent_decode_kernel"


def device_kernels(torch, fn):
    """``fn()``'s result and the kernels the card ran meanwhile, by name:
    the profiler's device events (CUPTI's, of every thread, and each
    kernel of a replayed CUDA graph).  A launch count credits a replayed
    graph with what its capture counted; this is what ran.  Raises where
    the profiler reports no device event at all."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            names[e.name()] = names.get(e.name(), 0) + 1
    assert names, "the profiler reported no device event"
    return out, names


def kernels_named(names, kernel: str) -> int:
    """Device events of ``device_kernels`` whose name holds ``kernel``."""
    return sum(n for k, n in names.items() if kernel in k)


def bound(nbytes: float, flops: float, dtype: str):
    """(``kernel_time_bound`` in ms at the peak for ``dtype``'s
    operations, which term binds)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (kernel_time_bound(nbytes, flops, peak_flops=PEAK_FLOPS[dtype])
            * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def fmt(d):
    """A result's numbers for a log line: floats to five figures, nested
    results left out."""
    return {k: (f"{v:.5g}" if isinstance(v, float) else v)
            for k, v in d.items() if not isinstance(v, dict)}


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


def graph_pool_bytes(torch, model):
    """Bytes the card holds in the memory pool of the model's decode
    graphs (its segments in the allocator's snapshot)."""
    pool = model._graph_pool
    if pool is None:
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def engine_decode_graphs(torch, eng, prompt, max_new):
    """One request served alone from a cold pool twice: through the
    model's decode graphs (its key captured at its second step, replayed
    after), then with the eager step in the dispatcher's place.  The
    tokens must be equal, the first run's steps replayed, and the card
    must run one paged kernel a layer a step in it (the profiler's
    count).  Logs each run's host ms a step (the engine's whole step,
    sampling and its sync included) and the graphs' counters and pool."""
    model = eng.model
    runs = {}
    for arm in ("graphs", "eager"):
        eng.release_warm()
        if arm == "eager":
            model.paged_decode_step = model._paged_decode_step_eager
        c0 = model.counters()
        step_s, _, undo = time_engine(eng)
        def serve():
            out = eng.generate([prompt], max_new_tokens=max_new)[0]
            eng.drain()         # the last step's timer appends after
            return out

        try:
            out, ran = device_kernels(torch, serve)
        finally:
            undo()
            if arm == "eager":
                del model.paged_decode_step
        c1 = model.counters()
        runs[arm] = (out, step_s, {k: c1[k] - c0[k] for k in c1},
                     kernels_named(ran, PAGED_KERNEL))
    (got, g_s, moved, g_ran), (want, e_s, still, e_ran) = \
        runs["graphs"], runs["eager"]
    assert got == want, ("the replayed steps' tokens differ from the "
                         f"eager step's at {first_difference(got, want)}")
    assert moved["decode_graph_replays"] >= len(g_s) - 2, moved
    layers = model.cfg.num_layers
    assert g_ran == layers * len(g_s) and e_ran == layers * len(e_s), \
        (g_ran, len(g_s), e_ran, len(e_s))
    assert still["decode_graph_replays"] == 0 \
        and still["decode_graph_captures"] == 0, still
    log("engine.decode_graphs", request_tokens=len(prompt),
        tokens_each=max_new, tokens="equal", decode_steps=len(g_s),
        replays=moved["decode_graph_replays"],
        captures=moved["decode_graph_captures"],
        capture_s=f"{moved['decode_graph_capture_s']:.3f}",
        paged_kernels_ran=g_ran,
        graphs_step_ms=f"{1e3 * sorted(g_s)[len(g_s) // 2]:.3f}",
        eager_step_ms=f"{1e3 * sorted(e_s)[len(e_s) // 2]:.3f}",
        graphs_held=len(model._graphs),
        graph_pool_mib=f"{graph_pool_bytes(torch, model) / 2**20:.1f}")


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
    step_s, _, undo = time_engine(dv, "_decode_once")
    names = ("cold_c", "cold_d", "share_a")
    da_ops.reset_counts()
    pd_ops.reset_counts()
    res = serve_requests(dv, prompts, max_new, names)
    torch.cuda.synchronize()
    da_n, pd_n = da_ops.launches, pd_ops.launches
    da_split = da_ops.split_launches
    n_steps = len(step_s)
    assert all(len(r) == max_new for r in res.values()), "short output"
    assert pd_n == 0 and n_steps > 0 \
        and da_n == cfg.num_layers * n_steps, (da_n, pd_n, n_steps)
    assert da_split == da_n, "a dense-view decode launch was not split"
    undo()
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
    # four requests and a duplicate, then one more after the first decode
    # step: up to five live rows
    requests = (("a", "b", "c", "d", "a_dup"), ("late_e",))
    outs, launches, step_s, admit_s, run_s = serve_dense(
        torch, eng, prompts, max_new, requests, fa_ops, da_ops, pd_ops,
        plain_calls, lru_ops=lru_ops)
    st = eng.stats
    assert outs["a_dup"] == outs["a"]
    assert st.coalesced_requests >= 1 and st.peak_batch >= 2, st.as_dict()
    assert launches["flash_attention"] > 0 \
        and launches["decode_attention"] > 0 \
        and launches["rglru_scan"] > 0, launches
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
        plain_calls=launches["plain_calls"])

    # a B=8 decode view of one prefilled 380-token row, and one prefill
    model = eng.model
    toks_a = torch.as_tensor([prompts["a"]], dtype=torch.int32, device=dev)
    _, cache = model.prefill(toks_a)
    row = model.extend_cache(cache, eng.max_seq_len - toks_a.shape[1])
    view = rows_view(torch, model, [row] * 8)
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
    diff, scale, same = decode_parity(torch, model, view, tok8)
    assert diff <= 5e-2 * scale, (diff, scale)
    log("hybrid.step_parity", rows=8, max_abs_diff=f"{diff:.4e}",
        logit_scale=f"{scale:.4e}", tolerance="5e-2*scale",
        same_argmax=same)
    del view, row, cache

    # batch invariance: the first request, decoded again alone; then the
    # same on a float32 copy of the weights, where other GEMM shapes at
    # B=1 and at B=8 differ by f32 rounding only, so a token that differs
    # there is a fault of the port, not bf16 rounding on flat logits
    e32, _ = batch_invariance(torch, InferenceEngine, eng, "hybrid",
                              prompts, outs, "a", max_new, requests)
    e32.shutdown()
    hybrid_ring(torch, model, e32.model, words, vocab)
    e32.unload()
    return launches


def ring_check(torch, phase, m32, toks, S, controls):
    """Prefill ``S`` of ``toks`` (past the window, S % window != 0), then
    decode the rest under "cuda": the logits must follow the
    teacher-forced forward, which needs position p in ring slot p % T.
    ``m32`` is a float32 model, where the two paths differ by rounding
    only (in bf16 their rounding differs by a few percent of the logit
    scale on random weights, which would hide a misplaced ring).
    ``controls`` maps a name to (a function of the prefilled cache giving
    a faulty one, whether its decode must fail the limit).  Returns the
    log line's fields."""
    n_dec = toks.shape[1] - S
    full, _ = m32(toks, impl="cuda")
    ref = full[0, S - 1:].clone()
    del full
    logits, cache = m32.prefill(toks[:, :S], impl="cuda")
    rings = [k for k in cache if k.split("_")[-1] in ("k", "v")]
    T = cache[rings[0]].shape[2]
    assert S > T and S % T and all(cache[k].shape[2] == T for k in rings)

    def decode(cache):
        got = [logits[0]]
        for i in range(n_dec):
            lg, cache = m32.decode_step(toks[:, S + i], cache, impl="cuda")
            got.append(lg[0])
        return torch.stack(got)

    faulty = {n: (make(cache), must_fail)
              for n, (make, must_fail) in controls.items()}
    got = decode(cache)
    diff = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    # f32 rounding leaves about 1.5e-5 of the scale; the limit sits above
    # it, and a control that must fail shows the check can see its fault
    limit = 1e-3 * scale
    assert bool(torch.isfinite(got).all()) and diff <= limit, (diff, scale)
    fields = {}
    for name, (c, must_fail) in faulty.items():
        ctrl = (decode(c) - ref).abs().max().item()
        assert ctrl > limit or not must_fail, (name, ctrl, scale)
        fields[f"control_{name}_max_abs_diff"] = \
            f"{ctrl:.4e}" + (": fails" if must_fail else "")
    log(phase, dtype="float32", prompt=S, window=T, ring_offset=S % T,
        decoded=n_dec, positions_checked=n_dec + 1,
        max_abs_diff=f"{diff:.4e}", logit_scale=f"{scale:.4e}",
        tolerance="1e-3*scale",
        same_argmax=torch.equal(got.argmax(-1), ref.argmax(-1)), **fields)


def reference_ring_placement(torch, S):
    """A control: the prefilled ring as the JAX reference places it (the
    last T positions in slots 0..T-1), from the port's (slot p % T)."""
    def make(cache):
        return {k: (torch.roll(v, -(S % v.shape[2]), dims=2)
                    if k.split("_")[-1] in ("k", "v") else v.clone())
                for k, v in cache.items()}
    return make


def hybrid_ring(torch, model, m32, words, vocab):
    """Prefill 2100 tokens (past the 2048 window, 2100 % 2048 != 0) on
    ``m32``, the float32 copy of ``model``, then decode 8 against the
    teacher-forced forward (``ring_check``); the ring as the JAX reference
    places it must fail."""
    S, n_dec = 2100, 8
    toks = torch.as_tensor(words.integers(1, vocab, S + n_dec),
                           dtype=torch.int32, device="cuda")[None]
    assert model.cfg.local_attn_window == 2048
    ring_check(torch, "hybrid.ring", m32, toks, S,
               {"slots_0_to_T": (reference_ring_placement(torch, S), True)})


def kernels_paged_one_chunk(torch, F, rng, pd_ops, fused_ref, q, pools):
    """The fused paged kernel at the Processor's decode shape (B=8, bf16 q
    over an f32 pool, the heads of ``q`` and ``pools``): tables of one
    chunk (8 pages, 64 keys), so every (row, KV head) is one block that
    writes its output directly, with no partials and no merge, and one
    padding row, as the engine pads a batch of 7.  Held against the plain
    version; the layers' pools are cycled as in ``[kernels.paged_main]``."""
    dev = q.device
    B, H, Dh = q.shape
    NL, P, ps, Hkv, _ = pools[0].shape
    NP = pd_ops.plan_chunk_pages(ps, Dh)
    lens_l = [NP * ps - 1, 1, 17, 40, NP * ps - 9, 3, 29, -1][:B]
    lens = torch.as_tensor(lens_l, dtype=torch.int32, device=dev)
    pt = torch.as_tensor(rng.permutation(P)[:B * NP].reshape(B, NP),
                         dtype=torch.int32).to(dev)
    assert max(pd_ops.row_chunks(n, ps, NP, NP) for n in lens_l) == 1

    def new_kv():
        return torch.as_tensor(rng.normal(size=(B, Hkv, Dh)),
                               dtype=torch.float32).to(dev)

    k_new, v_new = new_kv(), new_kv()
    kp, vp = pools[0][-1].clone(), pools[1][-1].clone()
    kr, vr = kp.clone(), vp.clone()
    n0, s0 = pd_ops.launches, pd_ops.split_launches
    out, k1, v1 = pd_ops.fused_paged_decode_attention(q, kp, vp, pt, lens,
                                                      k_new, v_new)
    ref, kr, vr = fused_ref(q, kr, vr, pt, lens, k_new, v_new)
    torch.cuda.synchronize()
    assert pd_ops.launches == n0 + 1 and pd_ops.split_launches == s0, \
        "a table of one chunk was split"
    err = (out.float() - ref.float()).abs().max().item()
    assert err < 3e-2, f"paged one-chunk err {err}"
    assert torch.equal(k1, kr) and torch.equal(v1, vr), \
        "paged one-chunk append differs from the plain scatter"
    del kp, vp, kr, vr
    layer = [0]

    def run():
        i = layer[0] = (layer[0] + 1) % NL
        return pd_ops.fused_paged_decode_attention(
            q, pools[0][i], pools[1][i], pt, lens, k_new, v_new)

    def plain():
        i = layer[0] = (layer[0] + 1) % NL
        return fused_ref(q, pools[0][i], pools[1][i], pt, lens, k_new, v_new)

    T = NP * ps
    kd = pools[0][0][pt.long()].reshape(B, T, Hkv, Dh).transpose(1, 2)
    vd = pools[1][0][pt.long()].reshape(B, T, Hkv, Dh).transpose(1, 2)
    qd = q.float()[:, :, None, :]
    dmask = (torch.arange(T, device=dev)[None, :]
             <= lens[:, None])[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(qd, kd, vd, attn_mask=dmask,
                                              enable_gqa=True)

    live = sum(min(n // ps + 1, NP) for n in lens_l if n >= 0)
    valid_tokens = sum(n + 1 for n in lens_l if n >= 0)
    nbytes = live * ps * Hkv * Dh * 4 * 2 + q.numel() * 2 * 2 \
        + 4 * (pt.numel() + B) + 2 * k_new.numel() * 4 * 2
    bnd, by = bound(nbytes, 4 * H * Dh * valid_tokens, "float32")
    s1 = pd_ops.split_launches
    res = {"shape": f"fused,B={B},table_pages={NP},ps={ps},Hkv={Hkv},"
                    f"Dh={Dh},q=bf16,pool=f32,lengths={lens_l}",
           "max_abs_err": err, "ms": time_ms(torch, run, iters=40),
           "device_ms": profile_calls(torch, run, 40)[1],
           "plain_ms": time_ms(torch, plain),
           "bound_ms": bnd, "bound_by": by,
           "library_ms": time_ms(torch, library)}
    assert pd_ops.split_launches == s1, "a timed one-chunk launch was split"
    res["split_launches"] = 0
    log("kernels.paged_one_chunk", **{k: (f"{v:.4g}" if isinstance(v, float)
                                          else v) for k, v in res.items()},
        tolerance=3e-2, append="bitwise", bytes=nbytes)
    return res


def processor_share(part: int, whole: int) -> str:
    return f"{part}/{whole}" + (f" ({part / whole:.3f})" if whole else "")


def results_compare(a, b):
    """(share of equal values over a's keys, first key that differs)."""
    keys = sorted(a)
    same = sum(1 for k in keys if a[k] == b.get(k))
    first = next((k for k in keys if a[k] != b.get(k)), None)
    return f"{same}/{len(keys)}", first


def processor_phases(torch, fa_ops, pd_ops, da_ops, sp_ops, lru_ops,
                     plain_calls):
    """Halo's batched workflows through the port's Processor at qwen3-1.7b's
    full width: ``RealProcessor.run`` over two workers, a resume from its
    checkpoint, the results against coalescing off and pipelining off (in
    bf16, and on a float32 copy of the weights, asserted), a
    ``ProcessorSession`` with a graft, and a KV migration between the
    workers' engines.  Returns the launches of its main path."""
    import tempfile

    from repro_torch.core import EpochDPSolver, SolverConfig, consolidate
    from repro_torch.engine import tokenizer
    from repro_torch.engine.engine import InferenceEngine
    from repro_torch.launch.serve import build_cost_model, model_configs
    from repro_torch.runtime import (KVMigrator, ProcessorConfig,
                                     ProcessorSession, RealProcessor)
    from repro_torch.runtime.executors import EngineHost
    from repro_torch.workloads import build_workload
    from repro_torch.workloads.datagen import build_database
    from repro_torch.workloads.tools import ToolRuntime

    def batch(name, n, n_workers):
        """(graph, bindings, consolidated graph, plan on h100, database)."""
        g, bindings, dbname = build_workload(name, n, seed=0)
        cons = consolidate(g, bindings)
        plan = EpochDPSolver(g.llm_dag(), build_cost_model(g, cons, "h100"),
                             SolverConfig(num_workers=n_workers)).solve()
        return g, bindings, cons, plan, build_database(dbname)

    workload, n_queries, workers, cap = "w5", 8, 2, 16
    work = batch(workload, n_queries, workers)
    g, bindings, cons, plan, db = work
    models = model_configs("cuda")
    n_results = n_queries * len(g.nodes)

    def config(**kw):
        kw.setdefault("num_workers", workers)
        return ProcessorConfig(decode_cap=cap, seed=0, hardware="h100", **kw)

    def run(hosts, cfg=None, models=models, work=work, **run_kw):
        g_, _, cons_, plan_, db_ = work
        proc = RealProcessor(g_, models, ToolRuntime(db_),
                             config=cfg or config())
        t0 = time.perf_counter()
        rep = proc.run(cons_, plan_, hosts=hosts, **run_kw)
        torch.cuda.synchronize()
        return rep, time.perf_counter() - t0

    def free(hosts):
        for h in hosts:
            h.shutdown()
            for e in h.engines():
                e.unload()
        gc.collect()
        torch.cuda.empty_cache()

    def longest_prompt(hosts):
        return max((len(p) for h in hosts for nid in g.llm_nodes()
                    for p in h.prompts_for(nid)), default=0)

    # ------------------------------------------------------------ the run
    def timed_run(*args, **kw):
        """``run`` with where its time goes: every engine's decode steps
        (wall and the loop thread's CPU seconds) and prefill calls (an
        admission's prefill, or a batch of cold ones), timed on the
        engines' loop threads."""
        t = {"step": [], "step_cpu": [], "admit": []}
        orig_decode = InferenceEngine._decode_paged
        orig_admit = {m: getattr(InferenceEngine, m) for m in PREFILL_CALLS}

        def timed_decode(self):
            t0, c0 = time.perf_counter(), time.thread_time()
            orig_decode(self)
            t["step_cpu"].append(time.thread_time() - c0)
            t["step"].append(time.perf_counter() - t0)

        def timed(orig):
            def timed_admit(self, *a):
                t0 = time.perf_counter()
                orig(self, *a)
                t["admit"].append(time.perf_counter() - t0)
            return timed_admit

        InferenceEngine._decode_paged = timed_decode
        for m, orig in orig_admit.items():
            setattr(InferenceEngine, m, timed(orig))
        try:
            return (*run(*args, **kw), t)
        finally:
            InferenceEngine._decode_paged = orig_decode
            for m, orig in orig_admit.items():
                setattr(InferenceEngine, m, orig)

    def mean_ms(xs):
        return f"{1e3 * sum(xs) / max(len(xs), 1):.3f}"

    mods = (fa_ops, pd_ops, da_ops, sp_ops, lru_ops)
    plain0 = plain_calls["n"]
    hosts = [EngineHost(models, seed=0) for _ in range(workers)]
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = f"{tmp}/batch.json"
        for m in mods:
            m.reset_counts()
        (rep, wall_s, times), ran = device_kernels(
            torch, lambda: timed_run(hosts, checkpoint_path=ckpt))
        launches = {"flash_attention": fa_ops.launches,
                    "flash_tensor_core": fa_ops.tensor_core_launches,
                    "paged_decode_attention": pd_ops.launches,
                    "paged_ran": kernels_named(ran, PAGED_KERNEL),
                    "paged_split": pd_ops.split_launches,
                    **paged_variant_counts(pd_ops),
                    "decode_attention": da_ops.launches,
                    "shared_prefix_attention": sp_ops.launches,
                    "rglru_scan": lru_ops.launches}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        res = rep.results()
        assert len(res) == n_results and all(
            isinstance(v, str) and v for v in res.values()), \
            f"{len(res)} of {n_results} results, or an empty one"
        x = rep.extra
        assert x["model_switches"] >= 1, "no model switch"
        assert launches["flash_attention"] > 0 \
            and launches["paged_decode_attention"] > 0, launches
        assert launches["paged_ran"] == launches["paged_decode_attention"], \
            f"the card ran other paged kernels than counted: {launches}"
        assert launches["flash_tensor_core"] == launches["flash_attention"], \
            "a bf16 flash launch missed the tensor cores"
        # a call splits its rows' pages across blocks when its table
        # holds more than one chunk: the engines record the widest table
        # they built
        longest = longest_prompt(hosts)
        engines = [e for h in hosts for e in h.engines()]
        chunk = pd_ops.plan_chunk_pages(engines[0].page_size,
                                        engines[0].cfg.head_dim)
        widest = max(e.stats.widest_decode_table for e in engines)
        ps = engines[0].page_size
        widest, chunk_keys = widest * ps, chunk * ps
        if widest > chunk_keys:
            assert launches["paged_split"] > 0, "no paged launch was split"
        else:
            assert launches["paged_split"] == 0, \
                "a table of one chunk was split"
        assert plain_calls["n"] == plain0, "a plain version ran"
        log("processor.run", workload=workload, queries=n_queries,
            workers=workers, decode_cap=cap, models="3 names x "
            "qwen3-1.7b(full width, 28 layers, bf16, seed 0)",
            plan_epochs=len(plan.epochs),
            plan_predicted_s=f"{plan.predicted_cost:.3f}",
            plan_hardware="h100", wall_s=f"{wall_s:.3f}",
            makespan_s=f"{rep.makespan:.3f}",
            queries_per_s=f"{n_queries / wall_s:.4f}",
            decode_tokens=x["decode_tokens"],
            model_switches=x["model_switches"],
            switch_s=f"{sum(h.switch_seconds for h in hosts):.3f}",
            prefill_tokens_saved=x["prefill_tokens_saved"],
            coalesced_requests=x["coalesced_requests"],
            admission_waves=x["admission_waves"],
            peak_batch=x["peak_batch"],
            coalesce_stats=json.dumps(rep.coalesce_stats),
            longest_prompt=longest, widest_table_keys=widest,
            chunk_keys=chunk_keys, max_memory_allocated_gib=f"{peak_gib:.3f}",
            flash_launches=launches["flash_attention"],
            flash_tensor_core=processor_share(
                launches["flash_tensor_core"], launches["flash_attention"]),
            paged_launches=launches["paged_decode_attention"],
            paged_split=processor_share(launches["paged_split"],
                                        launches["paged_decode_attention"]),
            other_launches=json.dumps(
                {k: launches[k] for k in ("decode_attention",
                                          "shared_prefix_attention",
                                          "rglru_scan")}),
            plain_calls=plain_calls["n"] - plain0)
        summary = rep.summary()
        log("processor.time", wall_s=f"{wall_s:.3f}",
            decode_steps=len(times["step"]),
            decode_step_s=f"{sum(times['step']):.3f}",
            mean_step_ms=mean_ms(times["step"]),
            mean_step_thread_cpu_ms=mean_ms(times["step_cpu"]),
            decode_tok_per_s=f"{x['decode_tokens'] / wall_s:.2f}",
            prefill_calls=len(times["admit"]),
            prefill_s=f"{sum(times['admit']):.3f}",
            prefill_ms_per_call=mean_ms(times["admit"]),
            llm_record_s=summary["gpu_seconds"],
            tool_record_s=summary["cpu_seconds"],
            cpu_gpu_overlap_s=x["cpu_gpu_overlap_s"],
            switch_s=f"{sum(h.switch_seconds for h in hosts):.3f}")

        # ------------------------------------------------------ resume
        again, resume_s = run(hosts, resume_from=ckpt)
        assert again.results() == res, "resumed results differ"
        assert again.coalesce_stats["restored_results"] == n_results
        assert again.extra["decode_tokens"] == 0, "resume recomputed"
        log("processor.resume", restored_results=again.coalesce_stats[
            "restored_results"], decode_tokens=again.extra["decode_tokens"],
            results="equal", wall_s=f"{resume_s:.3f}")
    free(hosts)

    # ------------------------------------------------------------ profile
    # the same run under the profiler: the device's busy time (its
    # kernels' intervals summed) against the run's wall time there
    from torch.profiler import ProfilerActivity, profile
    hs = [EngineHost(models, seed=0) for _ in range(workers)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prep, prof_s = run(hs)
    free(hs)
    per_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[e.name[:60]] = per_kernel.get(e.name[:60], 0.0) \
                + e.time_range.elapsed_us()
    del prof
    busy_s = sum(per_kernel.values()) / 1e6
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    log("processor.profile", wall_s_under_profiler=f"{prof_s:.3f}",
        device_busy_s=f"{busy_s:.3f}" if per_kernel else "not measured",
        device_busy_share=f"{busy_s / prof_s:.3f}" if per_kernel
        else "not measured",
        top_kernels_s=json.dumps([[k, round(us / 1e6, 4)]
                                  for k, us in top]),
        equal_results=results_compare(res, prep.results())[0])

    # --------------------------------------------------------- one worker
    # the same batch on one worker (one engine loop at a time, a plan
    # for one worker): does a decode step get back to the engine's own
    # time when no second engine loop shares the interpreter lock?
    w1 = batch(workload, n_queries, 1)
    hs = [EngineHost(models, seed=0)]
    one, one_s, t1 = timed_run(hs, config(num_workers=1), work=w1)
    free(hs)
    log("processor.one_worker", workers=1, plan_epochs=len(w1[3].epochs),
        wall_s=f"{one_s:.3f}", decode_steps=len(t1["step"]),
        mean_step_ms=mean_ms(t1["step"]),
        mean_step_thread_cpu_ms=mean_ms(t1["step_cpu"]),
        prefill_ms_per_call=mean_ms(t1["admit"]),
        two_workers_mean_step_ms=mean_ms(times["step"]),
        two_workers_mean_step_thread_cpu_ms=mean_ms(times["step_cpu"]),
        equal_results=results_compare(res, one.results())[0])

    # --------------------------------------------------------- invariance
    arms = {"coalescing_off": {"coalescing": False},
            "pipelining_off": {"pipelining": False}}
    for name, kw in arms.items():
        hs = [EngineHost(models, seed=0) for _ in range(workers)]
        other, arm_s = run(hs, config(**kw))
        free(hs)
        same, first = results_compare(res, other.results())
        log("processor.invariance", dtype="bfloat16", arm=name,
            equal_results=same, first_differing=first,
            cpu_gpu_overlap_s=other.extra["cpu_gpu_overlap_s"],
            wall_s=f"{arm_s:.3f}")
    # a float32 copy of the same weights: every arm must give the same
    # results, as the engine's float32 arms do
    eng = InferenceEngine(models["qwen3-14b"], seed=0)
    eng.load()
    sd32 = {k: v.float() for k, v in eng.model.state_dict().items()}
    eng.unload()
    del eng
    models32 = {m: c.replace(dtype="float32") for m, c in models.items()}

    def hosts32(**engine_kwargs):
        return [EngineHost(models32, seed=0, weights=lambda m: sd32,
                           engine_kwargs=engine_kwargs)
                for _ in range(workers)]

    proc32 = {}
    base32 = hosts32()
    for name, kw in {"base": {}, **arms}.items():
        hs = base32 if name == "base" else hosts32()
        r32 = run(hs, config(**kw), models=models32)[0]
        proc32[name] = r32.results()
        if name != "base":
            free(hs)
        same, first = results_compare(proc32["base"], proc32[name])
        log("processor.invariance", dtype="float32", arm=name,
            equal_results=same, first_differing=first,
            cpu_gpu_overlap_s=r32.extra["cpu_gpu_overlap_s"],
            equal_bf16=results_compare(res, proc32[name])[0])
    for name in arms:
        assert proc32[name] == proc32["base"], \
            f"float32 results move with {name}"

    # w5's tools are all roots, so no tool runs while an LLM node does
    # and pipelining has nothing to overlap there.  Workload wt (an LLM
    # node, two tools on its rows, an LLM node on theirs) at 4 queries
    # and max_batch 2 admits each node in two waves: pipelined, the first
    # wave's tools run while the second decodes.  Results must not move.
    wt = batch("wt", 4, workers)
    pipe = {}
    for on in (True, False):
        hs = hosts32(max_batch=2)
        r32, arm_s = run(hs, config(pipelining=on), models=models32,
                         work=wt)
        free(hs)
        pipe[on] = r32
        log("processor.pipelining", dtype="float32", workload="wt",
            queries=4, max_batch=2, pipelining=on,
            cpu_gpu_overlap_s=r32.extra["cpu_gpu_overlap_s"],
            admission_waves=r32.extra["admission_waves"],
            wall_s=f"{arm_s:.3f}")
    assert pipe[True].extra["cpu_gpu_overlap_s"] > 0, \
        "pipelining overlapped no tool with LLM work"
    assert pipe[True].results() == pipe[False].results(), \
        "float32 results move with pipelining"

    # ------------------------------------------------------------ migrate
    # a node worker 0 served with the model still resident there: its
    # warm prefixes move to worker 1's engine of that model, on the card
    src_host, dst_host = base32
    model = src_host.resident
    nid = next(n for n in reversed(g.topo_order()) if g.nodes[n].is_llm()
               and g.nodes[n].model == model and src_host.prompts_for(n))
    dst = dst_host.engine_for_import(model)
    pages0 = dst.stats.pages_migrated_in
    moved = KVMigrator(g, base32).migrate_node_from_peers(nid, 1)
    pages = dst.stats.pages_migrated_in - pages0
    assert moved > 0 and pages > 0, (moved, pages)
    dst_host.engine_for(model)         # resident: loads the weights only
    prompt = list(src_host.prompts_for(nid)[-1])
    n_new = min(g.nodes[nid].max_new_tokens, cap)
    hits0, saved0 = dst.stats.prefix_hits, dst.stats.prefill_tokens_saved
    warm = dst.generate([prompt], max_new_tokens=n_new)[0]
    hits = dst.stats.prefix_hits - hits0
    saved = dst.stats.prefill_tokens_saved - saved0
    dst.release_warm()
    cold = dst.generate([prompt], max_new_tokens=n_new)[0]
    assert hits == 1 and saved == len(prompt) - 1, (hits, saved)
    assert warm == cold, "migrated prefix changed the tokens"
    log("processor.migrate", node=nid, model=model, dtype="float32",
        prefixes_moved=moved, pages_migrated_in=pages,
        prompt_tokens=len(prompt), prefix_hit=hits, tokens_saved=saved,
        warm_equals_cold=warm == cold,
        equals_run_result=tokenizer.detokenize(warm) in {
            v for k, v in proc32["base"].items()
            if k.endswith(":" + nid)})
    free(base32)
    del sd32
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ session
    session = ProcessorSession(models, ToolRuntime(db), config=config())
    session.open()
    try:
        first = session.submit(g, bindings[:4])
        deadline = time.monotonic() + 300
        while sum(e.stats.decode_tokens for h in session.hosts
                  for e in h.engines()) == 0:
            assert time.monotonic() < deadline, "the first batch never decoded"
            time.sleep(0.002)
        second = session.submit(g, bindings[4:], slo="interactive")
        outs = [h.result(timeout=600) for h in first + second]
        session.drain(600)
        srep = session.report()
    finally:
        session.close()
    assert all(h.done() and h.exception() is None for h in first + second)
    assert all(len(o) == len(g.nodes) and all(o.values()) for o in outs)
    assert srep.extra["grafts"] == 1

    def ttft(handles):
        return json.dumps([round(h.ttft(), 4) for h in handles])

    log("processor.session", batch_queries=len(first),
        interactive_queries=len(second), grafts=srep.extra["grafts"],
        batch_ttft_s=ttft(first), interactive_ttft_s=ttft(second),
        admission_waves=srep.extra["admission_waves"],
        priority_jumps=srep.extra["priority_jumps"],
        makespan_s=f"{srep.makespan:.3f}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# the head groupings at Dh 128 of the models the engine phases serve:
# (model, H, Hkv); the first fills the kernels line's own entries, the
# others its "groups"
GROUPINGS = (("qwen3-1.7b", 16, 8), ("deepseek-moe-16b", 16, 16),
             ("llama3.2-3b", 24, 8), ("qwen3-8b", 32, 8),
             ("deepseek-67b", 64, 8), ("mixtral-8x22b", 48, 8))


def kernels_at_grouping(torch, F, rng, arch, H, Hkv):
    """Flash and the paged kernel at one model's head grouping, Dh 128,
    at the engine's shapes, each against its plain version and timed
    beside the card's bound and the PyTorch call for the same function.

    Flash at the chunk shape (B=1, a 512-token chunk after 32 cached
    keys, bf16), on the tensor cores.  The paged kernel at the decode
    step's shape (B=8 rows of 65 live pages, page 8, bf16 q over an f32
    pool; four layers' pools are cycled so each launch finds its pages
    out of L2, as a step does): fused against the plain version and
    bitwise equal to scatter-then-attend; under a wider table with rows
    of several lengths and a padding row, single against the plain
    version, blocked == single bitwise, and each row bitwise the same
    alone under its own table and in the batch (the split's chunk plan
    ignores B and the table's width); the attend-only arms timed; then
    ``kernels_paged_one_chunk``.  Returns {"flash": {...}, "paged":
    {...}, "arms": {"single": {...}, "blocked": {...}}}."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_decode_attention import ops as pd_ops
    from repro_torch.kernels.paged_decode_attention.ref import (
        fused_paged_decode_attention_ref, paged_decode_attention_ref,
        scatter_append_ref)
    dev = torch.device("cuda")
    Dh, G = 128, H // Hkv

    def rand(*shape, dtype=torch.bfloat16):
        return torch.as_tensor(rng.normal(size=shape),
                               dtype=torch.float32).to(dev, dtype)

    # ---- flash at the engine's chunk shape
    B, Sq, Skv = 1, 512, 544
    q, k, v = rand(B, Sq, H, Dh), rand(B, Skv, Hkv, Dh), \
        rand(B, Skv, Hkv, Dh)
    qp = torch.arange(Skv - Sq, Skv, dtype=torch.int32,
                      device=dev).expand(B, Sq).contiguous()
    kvp = torch.arange(Skv, dtype=torch.int32, device=dev).expand(
        B, Skv).contiguous()

    def fl_run():
        return fa_ops.flash_attention(q, k, v, q_positions=qp,
                                      kv_positions=kvp)

    def fl_plain():
        return flash_attention_ref(q, k, v, q_positions=qp,
                                   kv_positions=kvp)

    mask = kvp[:, None, None, :] <= qp[:, None, :, None]    # (B,1,Sq,Skv)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def fl_library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)

    n_tc = fa_ops.tensor_core_launches
    err = (fl_run().float() - fl_plain().float()).abs().max().item()
    assert err < 3e-2, f"{arch} flash err {err}"
    assert fa_ops.tensor_core_launches == n_tc + 1, \
        f"{arch} flash missed the tensor cores"
    sdpa_err = (fl_library().transpose(1, 2).float()
                - fl_plain().float()).abs().max().item()
    pairs = int(mask.sum().item())
    nbytes = 2 * (q.numel() * 2) + 2 * (k.numel() * 2) \
        + 4 * (qp.numel() + kvp.numel())
    bnd, by = bound(nbytes, 4 * Dh * H * pairs, "bfloat16")
    flash = {"G": G, "Hkv": Hkv, "max_abs_err": err,
             "ms": time_ms(torch, fl_run),
             "device_ms": profile_calls(torch, fl_run, 20)[1],
             "plain_ms": time_ms(torch, fl_plain),
             "bound_ms": bnd, "bound_by": by,
             "library_ms": time_ms(torch, fl_library)}
    log("kernels.flash_main", model=arch, shape=f"B={B},Sq={Sq},Skv={Skv},"
        f"H={H},Hkv={Hkv},Dh={Dh},bf16", tolerance=3e-2,
        sdpa_err=f"{sdpa_err:.3e}", body="tensor cores", **fmt(flash))
    del q, k, v, qt, kt, vt

    # ---- paged at the engine's decode step
    B, NP, ps, P, NL = 8, 65, 8, 1024, 4
    q = rand(B, H, Dh)
    pools = [rand(NL, P, ps, Hkv, Dh).float() for _ in range(2)]
    pt = torch.as_tensor(rng.permutation(P)[:B * NP].reshape(B, NP),
                         dtype=torch.int32).to(dev)
    lens = torch.full((B,), NP * ps - 3, dtype=torch.int32, device=dev)
    k_new, v_new = rand(B, Hkv, Dh).float(), rand(B, Hkv, Dh).float()
    ks, vs = scatter_append_ref(pools[0][0].clone(), pools[1][0].clone(),
                                pt, lens, k_new, v_new)
    ref = paged_decode_attention_ref(q, ks, vs, pt, lens)
    base = pd_ops.paged_decode_attention(q, ks, vs, pt, lens,
                                         variant="blocked")
    out, k0, v0 = pd_ops.fused_paged_decode_attention(
        q, pools[0][0], pools[1][0], pt, lens, k_new, v_new)
    pd_err = (out.float() - ref.float()).abs().max().item()
    assert pd_err < 3e-2, f"{arch} paged err {pd_err}"
    assert torch.equal(out, base) and torch.equal(k0, ks) \
        and torch.equal(v0, vs), f"{arch} fused != scatter-then-attend"
    del ks, vs

    chunk = pd_ops.plan_chunk_pages(ps, Dh)
    chunks_per_row = [pd_ops.row_chunks(int(n), ps, NP, chunk)
                      for n in lens.tolist()]
    var_lens = [NP * ps - 3, 2, chunk * ps, chunk * ps - 1, 20 * ps + 1,
                -1, 3 * chunk * ps + 5, 40 * ps + 7]
    wide = torch.as_tensor(rng.permutation(P)[:B * (NP + 7)].reshape(
        B, NP + 7), dtype=torch.int32).to(dev)
    var = torch.as_tensor(var_lens, dtype=torch.int32, device=dev)
    kp, vp = pools[0][1], pools[1][1]
    s0 = pd_ops.split_launches
    single = pd_ops.paged_decode_attention(q, kp, vp, wide, var,
                                           variant="single")
    assert pd_ops.split_launches == s0 + 1, f"{arch} wide table not split"
    single_err = (single.float() - paged_decode_attention_ref(
        q, kp, vp, wide, var).float()).abs().max().item()
    assert single_err < 3e-2, f"{arch} paged single err {single_err}"
    assert torch.all(single[5] == 0), f"{arch} padding row not pinned"
    for ppb in (2, 4, 8):
        assert torch.equal(pd_ops.paged_decode_attention(
            q, kp, vp, wide, var, variant="blocked", pages_per_block=ppb),
            single), f"{arch} blocked ppb={ppb}"
    batch = pd_ops.paged_decode_attention(q, kp, vp, wide, var,
                                          return_lse=True)
    for i, n in enumerate(var_lens):
        one = pd_ops.paged_decode_attention(
            q[i:i + 1].contiguous(), kp, vp,
            wide[i:i + 1, :max(1, n // ps + 1)].contiguous(),
            var[i:i + 1].contiguous(), return_lse=True)
        assert all(torch.equal(a[0], b[i]) for a, b in zip(one, batch)), \
            f"{arch} paged row {i} depends on its batch"
    layer = [0]

    def pd_run(variant="fused"):
        i = layer[0] = (layer[0] + 1) % NL
        if variant == "fused":
            return pd_ops.fused_paged_decode_attention(
                q, pools[0][i], pools[1][i], pt, lens, k_new, v_new)
        return pd_ops.paged_decode_attention(
            q, pools[0][i], pools[1][i], pt, lens, variant=variant)

    def pd_plain(fused=True):
        i = layer[0] = (layer[0] + 1) % NL
        if fused:
            return fused_paged_decode_attention_ref(
                q, pools[0][i], pools[1][i], pt, lens, k_new, v_new)
        return paged_decode_attention_ref(q, pools[0][i], pools[1][i], pt,
                                          lens)

    T = NP * ps
    kd = pools[0][0][pt.long()].reshape(B, T, Hkv, Dh).transpose(1, 2)
    vd = pools[1][0][pt.long()].reshape(B, T, Hkv, Dh).transpose(1, 2)
    qd = q.float()[:, :, None, :]
    dmask = (torch.arange(T, device=dev)[None, :]
             <= lens[:, None])[:, None, None, :]

    def pd_library():
        return F.scaled_dot_product_attention(qd, kd, vd, attn_mask=dmask,
                                              enable_gqa=True)

    # bytes: the live pages' K and V (every row's pages are distinct), q
    # in and out, m and l, the table and lengths, and (fused) the new K/V
    # read and written into the pool
    attend_bytes = B * NP * ps * Hkv * Dh * 4 * 2 + q.numel() * 2 * 2 \
        + 2 * B * H * 4 + 4 * (pt.numel() + B)
    append_bytes = 2 * k_new.numel() * 4 * 2
    valid_tokens = int((lens + 1).sum().item())
    flops = 4 * H * Dh * valid_tokens
    bnd, by = bound(attend_bytes + append_bytes, flops, "float32")
    s0 = pd_ops.split_launches
    pd_run()
    assert pd_ops.split_launches == s0 + 1, f"{arch} paged not split"
    library_ms = time_ms(torch, pd_library)
    pd_dev, pd_top = profile_calls(torch, pd_run, 40)[1:]
    paged = {"G": G, "Hkv": Hkv, "max_abs_err": pd_err,
             "ms": time_ms(torch, pd_run, iters=40), "device_ms": pd_dev,
             "plain_ms": time_ms(torch, pd_plain), "bound_ms": bnd,
             "bound_by": by, "library_ms": library_ms, "chunk_pages": chunk}
    log("kernels.paged_main", model=arch, shape=f"fused,B={B},live_pages="
        f"{NP},ps={ps},Hkv={Hkv},Dh={Dh},G={G},q=bf16,pool=f32",
        tolerance=3e-2, top_kernels_ms_per_call=json.dumps(pd_top),
        bytes=attend_bytes + append_bytes, peaks=json.dumps(PEAKS_OF),
        chunks_per_row=json.dumps(chunks_per_row),
        single_err=f"{single_err:.3e}", blocked_eq_single="bitwise",
        fused_eq_scatter_attend="bitwise",
        row_alone_vs_in_batch_of_8_wider_table="bitwise", **fmt(paged))

    # the attend-only arms (the variants "single" and "blocked" a table
    # may name) on the same inputs; the plain version is the gather-dense
    # reference
    arm_bound, arm_by = bound(attend_bytes, flops, "float32")
    arm_plain_ms = time_ms(torch, lambda: pd_plain(fused=False))
    arms = {}
    for variant in ("single", "blocked"):
        err = (pd_run(variant).float() - paged_decode_attention_ref(
            q, pools[0][layer[0]], pools[1][layer[0]], pt, lens).float()
        ).abs().max().item()
        assert err < 3e-2, f"{arch} paged {variant} err {err}"
        arms[variant] = {"max_abs_err": err,
                         "ms": time_ms(torch, lambda: pd_run(variant),
                                       iters=40),
                         "plain_ms": arm_plain_ms, "bound_ms": arm_bound,
                         "bound_by": arm_by, "library_ms": library_ms}
    log("kernels.paged_arms", model=arch, shape="as paged_main, attend only",
        **{f"{a}_{k}": v for a, r in arms.items()
           for k, v in fmt(r).items()})
    del kd, vd
    paged["one_chunk"] = kernels_paged_one_chunk(
        torch, F, rng, pd_ops, fused_paged_decode_attention_ref, q, pools)
    del pools
    torch.cuda.empty_cache()
    return {"flash": flash, "paged": paged, "arms": arms}


# ---------------------------------------------------------------------------
# the MoE family and the rest of the dense family, at full width
# ---------------------------------------------------------------------------

CUT_LAYERS = 4           # depth of the float32 copies (full width)
# the engine phases' prompts (words of each; a 131-token shared prefix
# leads share_a, share_b and late_e) and requests: four and a duplicate
# of cold_c at once, late_e after the first decode step
ENGINE_PROMPTS = {"shared": 130, "share_a": (70, True),
                  "share_b": (120, True), "cold_c": (379, False),
                  "cold_d": (149, False), "late_e": (40, True)}
ENGINE_REQUESTS = (("cold_c", "share_a", "share_b", "cold_d", "cold_c_dup"),
                   ("late_e",))


def family_prompts(np, tokenizer, vocab, seed, spec):
    """Prompts of random words, ``spec`` = {name: (words, share)}: a
    shared prefix of ``spec["shared"]`` words leads every prompt whose
    ``share`` is true.  Returns (prompts, the prefix's length)."""
    words = np.random.default_rng(seed)

    def text(n):
        return " ".join(f"w{int(x)}" for x in words.integers(0, 10**6, n))

    shared = tokenizer.tokenize(text(spec.pop("shared")), vocab)
    out = {}
    for name, (n, share) in spec.items():
        out[name] = shared + tokenizer.tokenize(text(n), vocab, False) \
            if share else tokenizer.tokenize(text(n), vocab)
    return out, len(shared)


# the engine's prefill calls: a request prefilled alone (a dense row, a
# donor's suffix, a request with extras: ``_admit_one(slot, donor,
# shared)``) and the cold prompts of one admission pass, batched
# (``_prefill_cold(slots)``)
PREFILL_CALLS = ("_admit_one", "_prefill_cold")


def time_engine(eng, attr="_decode_paged", kinds=None):
    """Wrap an engine's decode step (``attr``) and its prefill calls
    (``PREFILL_CALLS``) with host clocks.  Returns (step seconds, prefill
    call seconds, undo); a list ``kinds`` gets, for each prefill call,
    whether it prefilled a request with extras."""
    step_s, admit_s = [], []
    orig_decode = getattr(eng, attr)
    orig_admit = {m: getattr(eng, m) for m in PREFILL_CALLS}

    def timed_decode():
        t0 = time.perf_counter()
        orig_decode()
        step_s.append(time.perf_counter() - t0)

    def timed(orig):
        def timed_admit(first, *a):
            t0 = time.perf_counter()
            orig(first, *a)
            admit_s.append(time.perf_counter() - t0)
            if kinds is not None:
                slots = first if isinstance(first, list) else [first]
                kinds.append(any(s.req.extra for s in slots))
        return timed_admit

    setattr(eng, attr, timed_decode)
    for m, orig in orig_admit.items():
        setattr(eng, m, timed(orig))

    def undo():
        setattr(eng, attr, orig_decode)
        for m, orig in orig_admit.items():
            setattr(eng, m, orig)

    return step_s, admit_s, undo


def serve_requests(eng, prompts, max_new, first, late=(), extras=None):
    """Submit ``first`` at once, then ``late`` after the first decode step;
    a name ending in ``_dup`` repeats its stem's prompt; ``extras`` maps a
    name to its request's extras (patch embeddings, frames)."""
    extras = extras or {}

    def submit(n):
        return eng.submit(prompts[n.removesuffix("_dup")],
                          max_new_tokens=max_new, extra=extras.get(n))

    handles = {n: submit(n) for n in first}
    if late:
        deadline = time.monotonic() + 300
        while eng.stats.decode_tokens < 1:
            assert time.monotonic() < deadline, "engine made no decode step"
            time.sleep(0.001)
        handles.update({n: submit(n) for n in late})
    outs = {n: h.result(timeout=600) for n, h in handles.items()}
    eng.drain()             # the last step's timer appends after results
    return outs


def paged_variant_counts(pd_ops):
    """The paged kernel's launches of each variant since the last reset,
    as {"paged_single": n, "paged_blocked": n, "paged_fused": n}."""
    return {f"paged_{v}": n for v, n in pd_ops.variant_launches.items()}


def table_config(pd_ops, eng):
    """What the paged kernel's per-shape table names for an engine's pool
    and head grouping: {"variant", "pages_per_block"}, which the engine's
    decode launches."""
    cfg = eng.cfg
    return pd_ops.kernel_config(eng.page_size, cfg.num_kv_heads,
                                eng.model.head_dim,
                                cfg.num_heads // cfg.num_kv_heads)


def serve_checked(torch, eng, prompts, max_new, requests, fa_ops, pd_ops,
                  plain_calls, extras=None, kinds=None):
    """The main path's run of an engine phase: ``requests`` (first, late)
    served with the launch counts set to 0 just before and read just
    after.  Checks every output's length, the flash and paged launches, every
    bf16 flash launch on the tensor cores, every paged launch in the variant
    the paged kernel's table names for the engine (``table_config``), a
    split paged launch where a table passed one chunk, and no plain
    version.  The run is profiled: the paged kernels the card ran
    (``device_kernels``) must be as many as the counts credit, replayed
    decode graphs' included.  Returns (outputs, launches, step seconds,
    admission seconds, run seconds)."""
    step_s, admit_s, undo = time_engine(eng, kinds=kinds)
    n_plain = plain_calls["n"]
    fa_ops.reset_counts()
    pd_ops.reset_counts()
    t_run = time.perf_counter()
    outs, ran = device_kernels(torch, lambda: serve_requests(
        eng, prompts, max_new, *requests, extras=extras))
    run_s = time.perf_counter() - t_run
    launches = {"flash_attention": fa_ops.launches,
                "flash_tensor_core": fa_ops.tensor_core_launches,
                "paged_decode_attention": pd_ops.launches,
                "paged_ran": kernels_named(ran, PAGED_KERNEL),
                "paged_split": pd_ops.split_launches,
                **paged_variant_counts(pd_ops),
                "plain_calls": plain_calls["n"] - n_plain}
    undo()
    chunk = pd_ops.plan_chunk_pages(eng.page_size, eng.model.head_dim)
    assert all(len(o) == max_new for o in outs.values()), "short output"
    assert launches["flash_attention"] > 0 \
        and launches["paged_decode_attention"] > 0, launches
    assert launches["paged_ran"] == launches["paged_decode_attention"], \
        f"the card ran other paged kernels than the counts credit: {launches}"
    assert launches["flash_tensor_core"] == launches["flash_attention"], \
        "a bf16 flash launch missed the tensor cores"
    want = table_config(pd_ops, eng)["variant"]
    assert launches[f"paged_{want}"] == launches["paged_decode_attention"], \
        f"the engine decoded through another variant than {want}"
    assert eng.stats.widest_decode_table > chunk \
        and launches["paged_split"] > 0, \
        "no paged launch split though a table passed one chunk"
    assert launches["plain_calls"] == 0, \
        "a plain version ran on the CUDA path"
    return outs, launches, step_s, admit_s, run_s


def serve_dense(torch, eng, prompts, max_new, requests, fa_ops, da_ops,
                pd_ops, plain_calls, lru_ops=None, extras=None):
    """``serve_checked`` for the dense-row path: ``requests`` (first,
    late) served with the launch counts set to 0 just before and read
    just after.  Checks every output's length, no page allocated, every
    bf16 flash launch on the tensor cores, every decode launch split, no
    paged launch and no plain version.  Returns (outputs, launches, step
    seconds, admission seconds, run seconds)."""
    step_s, admit_s, undo = time_engine(eng, "_decode_once")
    for ops in (fa_ops, da_ops, pd_ops, lru_ops):
        if ops is not None:
            ops.reset_counts()
    plain0 = plain_calls["n"]
    t_run = time.perf_counter()
    outs = serve_requests(eng, prompts, max_new, *requests, extras=extras)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = {"flash_attention": fa_ops.launches,
                "flash_tensor_core": fa_ops.tensor_core_launches,
                "decode_attention": da_ops.launches,
                "decode_split": da_ops.split_launches,
                **({"rglru_scan": lru_ops.launches} if lru_ops else {}),
                "paged_decode_attention": pd_ops.launches,
                "plain_calls": plain_calls["n"] - plain0}
    undo()
    assert all(len(o) == max_new for o in outs.values()), "short output"
    assert eng.kv is None, "the dense-row path allocated pages"
    assert launches["flash_tensor_core"] == launches["flash_attention"], \
        "a bf16 flash launch missed the tensor cores"
    assert launches["decode_split"] == launches["decode_attention"], \
        "a decode launch was not split"
    assert launches["paged_decode_attention"] == 0, launches
    assert launches["plain_calls"] == 0, \
        "a plain version ran on the CUDA path"
    return outs, launches, step_s, admit_s, run_s


def batch_invariance(torch, InferenceEngine, eng, phase, prompts, outs,
                     name, max_new, requests, extras=None, layers=None,
                     asserted=True, check=None):
    """Request ``name``, served in the batch ``outs`` by ``eng`` (bf16),
    decoded again alone (logged), then the same on a float32 copy of the
    weights (cut to ``layers`` if given) that first serves ``requests``:
    there the lone tokens must equal the batched ones unless ``asserted``
    is false.  Warm rows are released before each lone run, so it
    prefills cold at a batch of one.  ``check(e32)`` runs once the copy
    has served.  The bf16 engine's loop stops once the copy has loaded.
    Returns the float32 engine, still loaded, and its outputs."""
    ex = [extras[name]] if extras else None

    def alone(e):
        e.release_warm()
        return e.generate([prompts[name]], max_new_tokens=max_new,
                          extras=ex)[0]

    alone16 = alone(eng)
    cfg = eng.cfg.replace(dtype="float32",
                          **({"num_layers": layers} if layers else {}))
    e32 = InferenceEngine(cfg, seed=0)
    e32.load(cut_copy(eng, layers) if layers          # bf16 -> f32, exact
             else eng.model.state_dict())
    eng.shutdown()
    outs32 = serve_requests(e32, prompts, max_new, *requests, extras=extras)
    assert all(len(o) == max_new for o in outs32.values()), "short output"
    if check:
        check(e32)
    alone32 = alone(e32)
    log(f"{phase}.batch_invariance", request=name,
        peak_batch=eng.stats.peak_batch,
        bf16=("equal" if alone16 == outs[name] else "differ"),
        bf16_first_differing_token=first_difference(alone16, outs[name]),
        float32_layers=cfg.num_layers,
        float32=("equal" if alone32 == outs32[name] else "differ"),
        float32_first_differing_token=first_difference(alone32,
                                                       outs32[name]),
        float32_asserted=asserted, float32_peak_batch=e32.stats.peak_batch,
        float32_tokens_equal_bf16_run=json.dumps(
            {n: outs32[n] == outs[n] for n in outs}))
    if asserted:
        assert alone32 == outs32[name], \
            (f"float32 {phase} tokens depend on the batch",
             first_difference(alone32, outs32[name]))
    return e32, outs32


def warm_step_inputs(torch, np, eng, rows, batch=None):
    """One decode step's inputs over ``rows`` of the engine's warm
    sequences, padded to ``batch`` rows of length -1 if given, as the
    engine pads: (tokens, page table, lengths), pages reserved."""
    dev = eng.device
    kv = eng.kv
    seqs = list(eng._warm)[:rows]
    kv.prepare_appends(seqs)
    batch = batch or len(seqs)
    n_pages = max(len(kv.sequences[s].page_ids) for s in seqs)
    pt = np.zeros((batch, n_pages), np.int32)
    lens = np.full((batch,), -1, np.int32)
    for i, s in enumerate(seqs):
        pt[i, :len(kv.sequences[s].page_ids)] = kv.sequences[s].page_ids
        lens[i] = kv.sequences[s].length
    tok = torch.arange(batch, dtype=torch.int32, device=dev) + 11
    return tok, torch.as_tensor(pt).to(dev), torch.as_tensor(lens).to(dev)


def step_parity(torch, np, eng, moe=None, rows=4, model=None, inputs=None):
    """One decode step of ``model`` (the engine's own by default) under
    impl="cuda" and impl="torch" over copies of the engine's pool, on
    ``inputs`` (tokens, page table, lengths: the engine's own step, whose
    first ``rows`` rows are real) or else on ``rows`` of its warm
    sequences: (max abs difference, logit scale, same argmax, and with
    ``moe`` the top-k expert selections that differ between the two, over
    every MoE layer and row)."""
    model = model or eng.model
    if inputs is None:
        inputs = warm_step_inputs(torch, np, eng, rows)
        rows = len(inputs[0])
    tok, pt, lens = inputs
    logits, routes = {}, {}
    for impl in ("cuda", "torch"):
        with (moe_routing(moe) if moe else
              contextlib.nullcontext()) as rec:
            lg, _, _ = model.paged_decode_step(
                tok, eng.kv.k.clone(), eng.kv.v.clone(), pt, lens,
                impl=impl)
        lg = lg[:rows]
        assert lg.shape == (rows, eng.cfg.padded_vocab) \
            and bool(torch.isfinite(lg).all()), impl
        logits[impl] = lg.float()
        routes[impl] = rec
    diff = (logits["cuda"] - logits["torch"]).abs().max().item()
    scale = logits["torch"].abs().max().item()
    same = torch.equal(logits["cuda"].argmax(-1), logits["torch"].argmax(-1))
    flips = None
    if moe:
        flips = 0
        for a, b in zip(routes["cuda"], routes["torch"]):
            ta, tb = (e["top_i"].reshape(-1, e["top_i"].shape[-1]).tolist()
                      for e in (a, b))
            flips += sum(len(set(x) - set(y)) for x, y in zip(ta, tb))
    return diff, scale, same, flips


def live_step_parity(torch, np, eng, models, n_extras, serve):
    """Run ``serve()`` with the engine model's paged step wrapped: at the
    first step whose batch holds the ``n_extras`` requests with extras
    that ``serve`` submits, each of
    ``models`` ({arm: model}) steps under impl="cuda" and impl="torch" on
    that step's own inputs over copies of the pool (``step_parity``),
    before the engine's step runs.  Returns ({arm: (max abs difference,
    logit scale, same argmax)}, the step's rows, of them with extras, the
    rows' lengths and the table's pages)."""
    inner = eng.model.paged_decode_step
    got = {}

    def step(tok, k, v, pt, lens, **kw):
        live = list(eng._active)
        if not got and sum(bool(s.req.extra) for s in live) == n_extras:
            got["rows"] = (len(live), n_extras,
                           [s.length for s in live], pt.shape[1])
            # with "rows" set, the engine model's calls pass through
            for arm, m in models.items():
                got[arm] = step_parity(
                    torch, np, eng, model=m, rows=len(live),
                    inputs=(tok, pt, lens))[:3]
        return inner(tok, k, v, pt, lens, **kw)

    eng.model.paged_decode_step = step
    try:
        serve()
    finally:
        del eng.model.paged_decode_step
    assert "rows" in got, "no step held every request with extras"
    return {a: got[a] for a in models}, *got["rows"]


def profile_engine(torch, np, eng, prompt, max_new, shapes=None):
    """Where a call's time goes, under the profiler: a few decode steps
    over the engine's warm rows (at most 8, padded to 8 as the engine
    pads; replays of the step's CUDA graph, captured before) and two
    cold chunk prefills of ``prompt`` (padded to the
    engine's bucket).  {call: (wall ms, device-busy ms, top kernels)}; the
    two steps' shapes go into ``shapes`` where given: {"decode": (B, table
    pages, page size, pool dtype, lengths), "prefill": (S, T)}."""
    dev = eng.device
    tok, pt, lens = warm_step_inputs(torch, np, eng, 8, batch=8)
    live = int((lens >= 0).sum().item())
    pad = -(-len(prompt) // eng._PF_QUANTUM) * eng._PF_QUANTUM
    T = eng._round_t(pad + max_new)
    chunk = torch.as_tensor([prompt + [0] * (pad - len(prompt))],
                            dtype=torch.int32, device=dev)
    valid = torch.tensor([len(prompt)], dtype=torch.int32, device=dev)

    def decode_step():
        eng.model.paged_decode_step(tok, eng.kv.k, eng.kv.v, pt, lens)

    # the step's graph captured before the profiled calls (a call of a
    # new key runs eagerly, the next one captures)
    decode_step()

    def prefill_chunk():
        eng.model.prefill_with_cache(chunk, eng._chunk_view(T),
                                     valid_len=valid)

    ps = eng.kv.k.shape[2]
    if shapes is not None:
        shapes.update(decode=(8, pt.shape[1], ps, eng.kv.k.dtype,
                              lens.tolist()), prefill=(pad, T))
    return {f"decode_step(B=8,{live} live rows,T={pt.shape[1] * ps})":
            profile_calls(torch, decode_step, 5),
            f"chunk_prefill(S={pad},T={T})":
            profile_calls(torch, prefill_chunk, 2)}


def cut_copy(eng, layers):
    """The engine's first ``layers`` layers with its embedding, final norm
    and head: a state_dict of the engine's own tensors, no copy, which
    outlive ``unload`` while it is held.  Loading it into a float32 model
    casts bf16 to f32 exactly."""
    return {k: v for k, v in eng.model.state_dict().items()
            if not k.startswith("blocks.") or int(k.split(".")[1]) < layers}


@contextlib.contextmanager
def moe_routing(moe):
    """Collect one entry per ``moe_ffn`` call, from any thread, out of what
    ``moe._dispatch_indices`` takes and gives: ``tokens`` (G*Ng),
    ``groups`` (G), ``capacity``, ``top_i`` (G, Ng, K), the experts
    chosen, and ``dropped``, the routed slots past their expert's
    capacity, as a device tensor (read after the run: no sync)."""
    rec, inner = [], moe._dispatch_indices

    def spy(top_idx, num_experts, capacity):
        pos, keep = inner(top_idx, num_experts, capacity)
        G, Ng = top_idx.shape[:2]
        rec.append({"tokens": G * Ng, "groups": G, "capacity": capacity,
                    "top_i": top_idx, "dropped": (~keep).sum()})
        return pos, keep

    moe._dispatch_indices = spy
    try:
        yield rec
    finally:
        moe._dispatch_indices = inner


def routing_counts(torch, rec, n_moe):
    """Group ``moe_routing`` entries into model calls (``n_moe`` layers
    each): every prefill chunk's and decode step's [slots (its padded
    tokens), capacity, routed slots dropped over its layers].  A decode
    step's groups are one token each."""
    calls = [rec[i:i + n_moe] for i in range(0, len(rec), n_moe)]
    assert all(len({(e["tokens"], e["capacity"]) for e in c}) == 1
               for c in calls), "a model call's layers disagree"
    dropped = torch.stack([torch.stack([e["dropped"] for e in c]).sum()
                           for c in calls]).tolist()
    out = {"prefill_chunks": [], "decode_steps": []}
    for c, d in zip(calls, dropped):
        kind = "decode_steps" if c[0]["tokens"] == c[0]["groups"] \
            else "prefill_chunks"
        out[kind].append([c[0]["tokens"], c[0]["capacity"], d])
    return out


def free_engine(torch, *engines):
    for e in engines:
        e.shutdown()
        e.unload()
    gc.collect()
    torch.cuda.empty_cache()


def moe_phases(torch, np, get_config, tokenizer, InferenceEngine, moe,
               fa_ops, pd_ops, plain_calls):
    """deepseek-moe-16b at full width in bf16 (random weights from seed 0,
    engine defaults): the qwen3 phase's six requests through flash
    prefill, the MoE layers and the fused paged decode, with the routing
    counts; its profile; the CUDA step against the plain step (bf16, and
    float32 on a depth-cut copy); batch invariance; a prompt cold and over
    a shared prefix.  Returns the kernels' launches in the run."""
    cfg = get_config("deepseek-moe-16b")
    n_moe = cfg.num_layers - cfg.moe.first_dense_layers
    eng = InferenceEngine(cfg, seed=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before_gib = torch.cuda.memory_allocated() / 2**30
    load_s = eng.load()
    prompts, n_shared = family_prompts(np, tokenizer, cfg.vocab_size, 3,
                                       dict(ENGINE_PROMPTS))
    max_new = 32
    with moe_routing(moe) as rec:
        outs, launches, step_s, admit_s, run_s = serve_checked(
            torch, eng, prompts, max_new, ENGINE_REQUESTS, fa_ops, pd_ops,
            plain_calls)
    st = eng.stats
    assert outs["cold_c_dup"] == outs["cold_c"]
    assert st.prefix_hits >= 1 and st.coalesced_requests >= 1 \
        and st.peak_batch >= 2, st.as_dict()
    routing = routing_counts(torch, rec, n_moe)
    del rec
    decode_s = sum(step_s)
    m = cfg.moe
    log("moe.run", model=f"deepseek-moe-16b(full width, {cfg.num_layers} "
        f"layers: {m.first_dense_layers} dense + {n_moe} MoE, "
        f"{m.num_experts} experts top-{m.top_k} + {m.num_shared_experts} "
        f"shared, {cfg.num_heads}/{cfg.num_kv_heads} heads, Dh "
        f"{cfg.resolved_head_dim})", dtype="bf16",
        params_gb=f"{eng.param_bytes() / 1e9:.3f}", requests=len(outs),
        prefill_calls=len(admit_s), tokens_each=max_new,
        shared_prefix=n_shared,
        prefix_hits=st.prefix_hits, coalesced=st.coalesced_requests,
        peak_batch=st.peak_batch, decode_steps=len(step_s),
        decode_tokens=st.decode_tokens, load_s=f"{load_s:.3f}",
        run_s=f"{run_s:.3f}",
        mean_step_ms=f"{1e3 * decode_s / len(step_s):.3f}",
        prefill_ms_per_call=f"{1e3 * sum(admit_s) / len(admit_s):.3f}",
        decode_tok_per_s=f"{st.decode_tokens / decode_s:.2f}",
        max_memory_allocated_gib=
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
        allocated_before_load_gib=f"{before_gib:.3f}",
        flash_launches=launches["flash_attention"],
        flash_tensor_core_launches=launches["flash_tensor_core"],
        paged_launches=launches["paged_decode_attention"],
        paged_split_launches=launches["paged_split"],
        widest_table_pages=st.widest_decode_table,
        plain_calls=launches["plain_calls"], routing=json.dumps(routing))

    # where a step's time goes: a decode step over the 5 warm rows padded
    # to 8, and the 380-token cold chunk prefill
    fields = {}
    for kind, (call, (wall, busy, top)) in zip(
            ("decode", "prefill"),
            profile_engine(torch, np, eng, prompts["cold_c"],
                           max_new).items()):
        fields.update({f"{kind}_call": call, f"{kind}_wall_ms": f"{wall:.3f}",
                       f"{kind}_device_busy_ms": f"{busy:.3f}",
                       f"{kind}_busy_share": f"{busy / wall:.3f}",
                       f"{kind}_top_kernels_ms": json.dumps(top)})
    log("moe.profile", **fields)

    # the CUDA step against the plain step: bf16 at full depth (logged,
    # with the router's top-k selections that differ), then float32 on a
    # depth-cut copy (asserted)
    diff, scale, same, flips = step_parity(torch, np, eng, moe)
    parity = {"bf16": {"max_abs_diff": f"{diff:.4e}",
                       "logit_scale": f"{scale:.4e}", "same_argmax": same,
                       "topk_selections_differing": flips}}

    def f32_parity(e32):
        diff, scale, same, flips = step_parity(torch, np, e32, moe)
        assert diff <= 1e-3 * scale, (diff, scale)
        parity["float32"] = {"layers": CUT_LAYERS,
                             "max_abs_diff": f"{diff:.4e}",
                             "logit_scale": f"{scale:.4e}",
                             "same_argmax": same,
                             "topk_selections_differing": flips}

    # batch invariance: at B <= 16 a decode group is one token, so the
    # routing cannot depend on the batch; asserted on the float32 copy
    # (cut in depth, which also holds the step parity's float32 arm over
    # its warm rows), logged in bf16 (a near-tied router choice may flip)
    e32, _ = batch_invariance(torch, InferenceEngine, eng, "moe", prompts,
                              outs, "cold_c", max_new, ENGINE_REQUESTS,
                              layers=CUT_LAYERS, check=f32_parity)
    log("moe.step_parity", rows=4, tolerance="float32 1e-3*scale; bf16 "
        "logged", arms=json.dumps(parity))

    # the same prompt cold, then admitted over a shared prefix (its donor
    # share_b), on the float32 copy: the chunks' capacities differ
    e32.release_warm()
    with moe_routing(moe) as rec:
        cold_out = e32.generate([prompts["share_a"]], max_new_tokens=max_new)
        e32.release_warm()
        e32.generate([prompts["share_b"]], max_new_tokens=1)
        hits = e32.stats.prefix_hits
        warm_out = e32.generate([prompts["share_a"]], max_new_tokens=max_new)
    assert e32.stats.prefix_hits == hits + 1, "share_a did not share"
    chunks = routing_counts(torch, rec, CUT_LAYERS - cfg.moe.first_dense_layers
                            )["prefill_chunks"]
    log("moe.prefix_sharing", request="share_a",
        prompt_tokens=len(prompts["share_a"]), shared_prefix=n_shared,
        float32_layers=CUT_LAYERS,
        cold_chunk=json.dumps(chunks[0]), warm_chunk=json.dumps(chunks[-1]),
        chunk_fields="[slots, capacity, dropped]",
        tokens=("equal" if cold_out == warm_out else "differ"),
        first_differing_token=first_difference(cold_out[0], warm_out[0]))
    free_engine(torch, e32, eng)
    return launches


def dense_family_phase(torch, np, arch, get_config, tokenizer,
                       InferenceEngine, fa_ops, pd_ops, da_ops, plain_calls,
                       layers=None):
    """``arch`` at full width in bf16 (random weights from seed 0, engine
    defaults), cut to ``layers`` when given: four requests of 100-300
    tokens, 16 new each, one sharing a prefix, through flash prefill and
    the fused paged decode; the CUDA step against the plain step; then a
    float32 copy cut in depth served on the paged path and on the dense
    view (decode attention), whose greedy tokens must agree.  Returns the
    kernels' launches."""
    full = get_config(arch)
    cfg = full.replace(num_layers=layers) if layers else full
    depth = f"{cfg.num_layers}" + (f" of {full.num_layers}" if layers
                                   else "") + " layers"
    tag = "dense." + arch.replace("-", "_").replace(".", "_")
    eng = InferenceEngine(cfg, seed=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before_gib = torch.cuda.memory_allocated() / 2**30
    load_s = eng.load()
    torch.cuda.empty_cache()        # the init's float32 draws, cached
    free_gib = torch.cuda.mem_get_info()[0] / 2**30
    assert free_gib >= 8, f"{free_gib:.1f} GiB free after the load"
    prompts, n_shared = family_prompts(
        np, tokenizer, cfg.vocab_size, 5,
        {"shared": 100, "share_a": (80, True), "share_b": (190, True),
         "cold_c": (250, False), "cold_d": (120, False)})
    assert all(100 <= len(p) <= 300 for p in prompts.values())
    max_new = 16
    outs, launches, step_s, admit_s, _ = serve_checked(
        torch, eng, prompts, max_new, (tuple(prompts), ()), fa_ops, pd_ops,
        plain_calls)
    st = eng.stats
    assert st.prefix_hits >= 1, st.as_dict()
    peak = torch.cuda.max_memory_allocated() / 2**30
    params_gb = eng.param_bytes() / 1e9
    diff, scale, same, _ = step_parity(torch, np, eng)
    assert diff <= 5e-2 * scale, (diff, scale)

    # a float32 copy cut in depth: the paged path against the dense view
    cut = cfg.replace(dtype="float32", num_layers=CUT_LAYERS)
    sd = cut_copy(eng, CUT_LAYERS)
    free_engine(torch, eng)
    arms = {}
    da_ops.reset_counts()
    for paged in (True, False):
        e = InferenceEngine(cut, seed=0, paged_decode=paged)
        e.load(sd)
        arms[paged] = serve_requests(e, prompts, max_new, tuple(prompts))
        free_engine(torch, e)
    launches["decode_attention_dense_view"] = da_ops.launches
    assert arms[True] == arms[False], "paged and dense-view tokens differ"
    assert da_ops.launches > 0, "the dense view launched no decode kernel"
    decode_s = sum(step_s)
    log(tag, model=f"{arch}(full width, {depth}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, G="
        f"{cfg.num_heads // cfg.num_kv_heads}, Dh "
        f"{cfg.resolved_head_dim}, "
        f"{'tied' if cfg.tie_embeddings else 'untied'} head)", dtype="bf16",
        params_gb=f"{params_gb:.3f}", requests=len(outs),
        tokens_each=max_new, shared_prefix=n_shared,
        prefix_hits=st.prefix_hits, peak_batch=st.peak_batch,
        decode_steps=len(step_s), load_s=f"{load_s:.3f}",
        mean_step_ms=f"{1e3 * decode_s / len(step_s):.3f}",
        prefill_ms_per_call=f"{1e3 * sum(admit_s) / len(admit_s):.3f}",
        decode_tok_per_s=f"{st.decode_tokens / decode_s:.2f}",
        max_memory_allocated_gib=f"{peak:.3f}",
        allocated_before_load_gib=f"{before_gib:.3f}",
        free_gib_after_load=f"{free_gib:.3f}",
        flash_launches=launches["flash_attention"],
        flash_tensor_core_launches=launches["flash_tensor_core"],
        paged_launches=launches["paged_decode_attention"],
        paged_split_launches=launches["paged_split"],
        widest_table_pages=st.widest_decode_table,
        plain_calls=launches["plain_calls"],
        step_parity=json.dumps({"max_abs_diff": f"{diff:.4e}",
                                "logit_scale": f"{scale:.4e}",
                                "same_argmax": same,
                                "tolerance": "5e-2*scale"}),
        float32_layers=CUT_LAYERS, paged_vs_dense_view="equal",
        dense_view_decode_launches=da_ops.launches)
    return launches


# ---------------------------------------------------------------------------
# sliding-window attention: mixtral-8x22b on dense rows
# ---------------------------------------------------------------------------

MIXTRAL_LAYERS = 12      # of 56: 60.9 GB of bf16 weights on one card
MIXTRAL_F32_LAYERS = 3   # the float32 copies: 31.6 GB each
# words of each prompt (plus BOS): two past the 4096-token window at an S
# that is no multiple of it, four under it; five at once, one after the
# first decode step
MIXTRAL_PROMPTS = {"long_a": 4499, "short_b": 149, "long_c": 4199,
                   "short_d": 379, "short_e": 99, "late_f": 229}
MIXTRAL_REQUESTS = (("long_a", "short_b", "long_c", "short_d", "short_e"),
                    ("late_f",))


def routed_parity(torch, moe, model, view, tok):
    """One decode step of an MoE model under impl="cuda" and impl="torch"
    over copies of ``view``, as ``decode_parity``, with the router's top-k
    expert selections that differ between the two, over every layer, for
    each row (a decode step routes each row alone).  Returns a log
    record: the difference over all rows and over the rows where no
    selection differs."""
    logits, tops = {}, {}
    for impl in ("cuda", "torch"):
        with moe_routing(moe) as rec:
            lg, _ = model.decode_step(tok, {k: v.clone() for k, v in
                                            view.items()}, impl=impl)
        assert lg.shape == (len(tok), model.cfg.padded_vocab) \
            and bool(torch.isfinite(lg).all()), impl
        logits[impl] = lg.float()
        tops[impl] = [e["top_i"].reshape(len(tok), -1).tolist()
                      for e in rec]
    flips = [sum(len(set(a[i]) - set(b[i]))
                 for a, b in zip(tops["cuda"], tops["torch"]))
             for i in range(len(tok))]
    clean = [i for i, f in enumerate(flips) if f == 0]
    d = (logits["cuda"] - logits["torch"]).abs()
    scale = logits["torch"].abs().max().item()
    same = torch.equal(logits["cuda"].argmax(-1), logits["torch"].argmax(-1))
    return {**parity_fields(d.max().item(), scale, same),
            "topk_selections_differing": sum(flips),
            "rows_without_a_differing_selection": len(clean),
            "max_abs_diff_over_those_rows": (
                f"{d[clean].max().item():.4e}" if clean else None)}


def swa_phases(torch, np, get_config, tokenizer, InferenceEngine,
               build_model, fa_ops, pd_ops, da_ops, plain_calls):
    """mixtral-8x22b at full width in bf16, depth cut to
    ``MIXTRAL_LAYERS`` (random weights from seed 0, max_seq_len 4608):
    six requests through flash prefill (window 4096), the MoE layers and
    the decode kernel over each row's ring on the dense-row path, the two
    long rows past the window; its profile; the CUDA step against the
    plain step in bf16 on a view of wrapped rings.  Then float32 copies
    cut to ``MIXTRAL_F32_LAYERS``: the same requests' greedy tokens on the
    kernels equal to the plain versions' (``attention_impl="torch"``),
    and, at a dropless capacity, a ring past the window against the
    teacher-forced forward (``ring_check``).  Returns the kernels'
    launches in the serving run."""
    from repro_torch.engine.models import moe
    dev = torch.device("cuda")
    full = get_config("mixtral-8x22b")
    cfg = full.replace(num_layers=MIXTRAL_LAYERS)
    depth = f"{MIXTRAL_LAYERS} of {full.num_layers} layers"
    eng = InferenceEngine(cfg, seed=0, max_seq_len=4608)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    load_s = eng.load()
    torch.cuda.empty_cache()        # the init's float32 draws, cached
    free_gib = torch.cuda.mem_get_info()[0] / 2**30
    assert free_gib >= 8, f"{free_gib:.1f} GiB free after the load"
    prompts = word_prompts(np, tokenizer, cfg.vocab_size, 9,
                           MIXTRAL_PROMPTS)
    W = cfg.swa_window
    lens = {n: len(p) for n, p in prompts.items()}
    assert sum(n > W and n % W != 0 for n in lens.values()) == 2
    max_new = 24
    kinds = []
    outs, launches, step_s, admit_s, run_s = serve_dense(
        torch, eng, prompts, max_new, MIXTRAL_REQUESTS, fa_ops, da_ops,
        pd_ops, plain_calls)
    st = eng.stats
    assert launches["flash_attention"] > 0 \
        and launches["decode_attention"] > 0, launches
    decode_s = sum(step_s)
    m = cfg.moe
    tag = "swa.mixtral_8x22b"
    log(f"{tag}.run", model=f"mixtral-8x22b(full width, {depth}, "
        f"{m.num_experts} experts top-{m.top_k}, {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads, Dh {cfg.resolved_head_dim}, window "
        f"{W})", dtype="bf16", params_gb=f"{eng.param_bytes() / 1e9:.3f}",
        requests=len(outs), prompt_tokens=json.dumps(lens),
        tokens_each=max_new, peak_batch=st.peak_batch,
        view_rebuilds=st.view_rebuilds, decode_steps=len(step_s),
        decode_tokens=st.decode_tokens, kv_pages="none",
        load_s=f"{load_s:.3f}", free_gib_after_load=f"{free_gib:.3f}",
        run_s=f"{run_s:.3f}")
    log(f"{tag}.perf", depth=depth,
        mean_step_ms=f"{1e3 * decode_s / len(step_s):.3f}",
        prefill_ms_per_request=json.dumps(
            [round(1e3 * a, 3) for a in admit_s]),
        decode_tok_per_s=f"{st.decode_tokens / decode_s:.2f}",
        max_memory_allocated_gib=
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
        launches=json.dumps(launches),
        flash_per_request=f"{launches['flash_attention'] / len(admit_s):.1f}",
        decode_per_step=f"{launches['decode_attention'] / len(step_s):.1f}")

    # a B=8 view of the 4500-token row's wrapped ring, and its prefill
    model = eng.model
    toks_a = torch.as_tensor([prompts["long_a"]], dtype=torch.int32,
                             device=dev)
    _, cache = model.prefill(toks_a)
    assert cache["k"].shape[2] == W
    view = rows_view(torch, model, [model.extend_cache(cache, max_new)] * 8)
    tok8 = torch.arange(8, dtype=torch.int32, device=dev) + 11
    fields = {}
    for kind, fn, n in (
            ("decode", lambda: model.decode_step(tok8, view), 5),
            ("prefill", lambda: model.prefill(toks_a), 2)):
        wall, busy, top = profile_calls(torch, fn, n)
        fields.update({f"{kind}_wall_ms": f"{wall:.3f}",
                       f"{kind}_device_busy_ms": f"{busy:.3f}",
                       f"{kind}_busy_share": f"{busy / wall:.3f}",
                       f"{kind}_top_kernels_ms": json.dumps(top)})
    log(f"{tag}.profile", depth=depth,
        calls=f"decode_step(B=8,T={W},positions {lens['long_a']}+), "
        f"prefill(S={lens['long_a']})", **fields)
    # the CUDA step against the plain step, with the router's top-k
    # selections that differ between the two (a near-tied choice that
    # bf16 rounding flips moves its row's logits past any rounding
    # limit): asserted in bf16 over the rows where none differs, which
    # must be at least half of them (a fault that flips every row's
    # routing fails), and on the float32 copy below
    parity = {"bf16": routed_parity(torch, moe, model, view, tok8)}
    del view, cache

    # float32 copies cut in depth, from the bf16 engine's own tensors
    sd = cut_copy(eng, MIXTRAL_F32_LAYERS)
    free_engine(torch, eng)
    cut = cfg.replace(dtype="float32", num_layers=MIXTRAL_F32_LAYERS)
    tokens = {}
    for impl in ("cuda", "torch"):
        e = InferenceEngine(cut.replace(attention_impl=impl), seed=0,
                            max_seq_len=4608)
        e.load(sd)
        tokens[impl] = serve_requests(e, prompts, max_new,
                                      *MIXTRAL_REQUESTS)
        free_engine(torch, e)
    log(f"{tag}.plain_tokens", float32_layers=MIXTRAL_F32_LAYERS,
        requests=len(prompts), tokens=(
            "equal" if tokens["cuda"] == tokens["torch"] else "differ"),
        first_differing_token=json.dumps(
            {n: first_difference(tokens["cuda"][n], tokens["torch"][n])
             for n in prompts}))
    assert tokens["cuda"] == tokens["torch"], \
        "the kernels' greedy tokens differ from the plain versions'"

    # the ring past the window against the forward, at a capacity that
    # drops nothing (so a prefill and a forward of other lengths route
    # alike); the ring as the JAX reference places it and a ring that
    # kept the first T positions must fail
    dropless = cut.replace(moe=dataclasses.replace(
        cut.moe, capacity_factor=cut.moe.num_experts / cut.moe.top_k))
    m32 = build_model(dropless, device=dev)
    m32.load_state_dict(sd)
    del sd
    _, cache = m32.prefill(toks_a)
    view = rows_view(torch, m32, [m32.extend_cache(cache, max_new)] * 8)
    parity["float32"] = routed_parity(torch, moe, m32, view, tok8)
    del view, cache
    log(f"{tag}.step_parity", depth=depth, rows=8,
        float32_layers=MIXTRAL_F32_LAYERS, arms=json.dumps(parity),
        tolerance="bf16 5e-2*scale over the rows where no top-k selection "
        "differs (at least 4 of 8), float32 1e-3*scale over all")
    bf16, f32 = parity["bf16"], parity["float32"]
    assert bf16["rows_without_a_differing_selection"] >= 4, bf16
    assert float(bf16["max_abs_diff_over_those_rows"]) \
        <= 5e-2 * float(bf16["logit_scale"]), bf16
    assert float(f32["max_abs_diff"]) <= 1e-3 * float(f32["logit_scale"])
    S, n_dec = lens["long_a"], 8
    toks = torch.as_tensor([prompts["long_a"] + prompts["short_b"][1:9]],
                           dtype=torch.int32, device=dev)
    assert toks.shape[1] == S + n_dec

    def first_positions(cache):
        return dict(m32.prefill(toks[:, :W], impl="cuda")[1],
                    length=cache["length"].clone())

    ring_check(torch, f"{tag}.ring", m32, toks, S,
               {"slots_0_to_T": (reference_ring_placement(torch, S), True),
                "first_T_positions": (first_positions, True)})
    del m32
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the last single-card families: VLM, ssm, encoder-decoder
# ---------------------------------------------------------------------------

def bf16_agreement(torch, out, ref):
    """A bf16 output against its plain version: (max abs error, RMS
    error, the reference's RMS, whether it holds: every element within the
    bf16 op tolerance, 2e-3 + 8e-3*|ref|, and the RMS error within 5% of
    the reference's RMS).  Softmax over 1000-1500 N(0,1) values gives
    outputs of RMS about 0.04, where a fixed 3e-2 would pass a kernel that
    drops its last key tile."""
    o, r = out.float(), ref.float()
    d = (o - r).abs()
    tol = op_tol(torch, torch.bfloat16)
    within = bool((d <= tol["atol"] + tol["rtol"] * r.abs()).all())
    rms_err = d.pow(2).mean().sqrt().item()
    rms_ref = r.pow(2).mean().sqrt().item()
    return (d.max().item(), rms_err, rms_ref,
            within and rms_err <= 5e-2 * rms_ref)


BF16_AGREEMENT = "every element 2e-3+8e-3*|ref|, RMS error 5e-2*ref RMS"


def window_agreement(torch, out, ref, part, noise=None):
    """``bf16_agreement`` with its RMS rule held over ``part`` too (a
    boolean mask of the leading axes: the rows a window or a wrapped ring
    acts on, where a fault there shows), and every element within 2e-3 +
    8e-3*|ref| + 3.125e-2*``noise``.  ``noise`` (default 0) is
    ``p_rounding_scale``: a kernel that rounds P to bf16 in another order
    than its plain version differs from it by about 2^-8 of that root sum
    of squares, and by at most 2^-7 of its terms' sum, which four times
    2^-7 of it covers for up to 16 like terms (the causal prefill's first
    rows, whose outputs of a few large values of V cancel).  Returns
    {max_abs_err, rms_err, part_rms_err, part_ref_rms, limit_share (the
    largest element error over its limit), worst (where that is), ok}."""
    d = (out.float() - ref.float()).abs()
    r = ref.float()
    limit = 2e-3 + 8e-3 * r.abs()
    if noise is not None:
        limit = limit + 3.125e-2 * noise
    share = d / limit
    at = share.argmax()
    worst = [int(i) for i in torch.unravel_index(at, share.shape)]

    def rms(x):
        return x.pow(2).mean().sqrt().item()

    res = {"max_abs_err": d.max().item(), "rms_err": rms(d),
           "part_rms_err": rms(d[part]), "part_ref_rms": rms(r[part]),
           "limit_share": share.flatten()[at].item(),
           "worst": (f"index {worst}: err {d.flatten()[at].item():.3e}, "
                     f"|ref| {r.abs().flatten()[at].item():.3e}" + (
                         "" if noise is None else
                         f", noise {noise.flatten()[at].item():.3e}"))}
    res["ok"] = res["limit_share"] <= 1 \
        and res["rms_err"] <= 5e-2 * rms(r) \
        and res["part_rms_err"] <= 5e-2 * res["part_ref_rms"]
    return res


def window_rule(noise):
    return ("every element 2e-3+8e-3*|ref|" + (
        "+3.125e-2*sqrt(sum_j p_j^2 v_j^2)" if noise else "") +
        ", RMS error 5e-2*ref RMS over all rows and over the rows the "
        "window acts on")


def p_rounding_scale(torch, q, k, v, **mask):
    """(B,Sq,H,Dh) f32: sqrt(sum_j p_j^2 v_j^2) over the plain version's
    probabilities p and V, each output element's scale of the difference
    that rounding P to bf16 in another order leaves in PV.  ``mask``: the
    positions, causal and window, as ``flash_attention_ref`` takes them."""
    from repro_torch.kernels.flash_attention.ref import _probs
    _, p = _probs(q, k, mask["q_positions"], mask["kv_positions"],
                  mask.get("causal", True), mask.get("window", 0))
    s = torch.einsum("bhgqk,bkhd->bqhgd", p.square(), v.float().square())
    return s.sqrt().reshape(q.shape)


def last_tile_dropped(torch, kvp, tile=64):
    """``kvp`` (valid keys a prefix of each row) with each row's valid keys
    in its last ``tile``-key tile set to -1: what a kernel that skipped the
    ragged tile would attend to."""
    start = ((kvp >= 0).sum(dim=1, keepdim=True) - 1).clamp(min=0) \
        // tile * tile
    idx = torch.arange(kvp.shape[1], device=kvp.device)[None]
    return torch.where(idx >= start, -1, kvp).to(kvp.dtype).contiguous()


def kernels_swa(torch, F, t, rng, fa_ops, da_ops, flash_attention_ref,
                decode_attention_ref):
    """The flash and decode kernels at mixtral-8x22b's shapes: 48 query
    heads over 8 KV heads (G = 6, in the kernels' 8-row instances), Dh
    128, window 4096, bf16.  Flash at a 4500-token causal prefill (B=1) on
    the tensor cores; the decode kernel at a step of B=8 rows over a
    4096-slot ring, four of whose rows have wrapped (the others hold 120
    to 399 positions and empty slots), split.  Each is held by
    ``window_agreement`` to its plain version (flash with P's rounding
    noise, ``p_rounding_scale``; the ring at ``bf16_agreement``'s element
    rule), with two controls that must fail it (each row's last 64-key tile dropped; the window ignored,
    or the wrapped rings' positions read as slots 0..T-1), and timed
    beside the plain version and SDPA.  Returns {"prefill": numbers,
    "ring": numbers}."""
    import numpy as np
    dev = torch.device("cuda")
    H, Hkv, Dh, W = 48, 8, 128, 4096
    res = {}

    # ---- flash at the prefill of a prompt past the window
    B, S = 1, 4500
    q = t(rng.normal(size=(B, S, H, Dh)), torch.bfloat16)
    k = t(rng.normal(size=(B, S, Hkv, Dh)), torch.bfloat16)
    v = t(rng.normal(size=(B, S, Hkv, Dh)), torch.bfloat16)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None].contiguous()

    def run():
        return fa_ops.flash_attention(q, k, v, q_positions=pos,
                                      kv_positions=pos, window=W)

    def plain():
        return flash_attention_ref(q, k, v, q_positions=pos,
                                   kv_positions=pos, window=W)

    gap = pos[0][:, None] - pos[0][None, :]
    band = (gap >= 0) & (gap < W)                          # (S, S)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band,
                                              enable_gqa=True)

    n_tc = fa_ops.tensor_core_launches
    ref = plain()
    past = torch.zeros(B, S, dtype=torch.bool, device=dev)
    past[:, W:] = True                            # rows the window cuts
    noise = p_rounding_scale(torch, q, k, v, q_positions=pos,
                             kv_positions=pos, window=W)
    a = window_agreement(torch, run(), ref, past, noise)
    assert fa_ops.tensor_core_launches == n_tc + 1, \
        "windowed flash missed the tensor cores"
    assert a["ok"], f"windowed flash: {a}"
    controls = {}
    for name, kvp, w in (("window_ignored", pos, 0),
                         ("last_tile_dropped", last_tile_dropped(torch, pos),
                          W)):
        c = window_agreement(torch, flash_attention_ref(
            q, k, v, q_positions=pos, kv_positions=kvp, window=w), ref,
            past, noise)
        assert not c["ok"], f"the check cannot see {name}: {c}"
        controls[f"control_{name}"] = (
            f"max {c['max_abs_err']:.3e} ({c['limit_share']:.2f} of its "
            f"limit), RMS past the window {c['part_rms_err']:.3e}: fails")
    del noise
    sdpa_err = (library().transpose(1, 2).float() - ref.float()
                ).abs().max().item()
    del ref
    pairs = int(band.sum().item())
    nbytes = 2 * q.numel() * 2 + 2 * k.numel() * 2 + 4 * 2 * S
    b_ms, b_by = bound(nbytes, 4 * Dh * H * pairs, "bfloat16")
    r = {"shape": f"B={B},S={S},H={H},Hkv={Hkv},G={H // Hkv},Dh={Dh},"
                  f"causal,window={W},bf16",
         "max_abs_err": a["max_abs_err"],
         "ms": time_ms(torch, run, iters=10),
         "device_ms": profile_calls(torch, run, 10)[1],
         "plain_ms": time_ms(torch, plain, iters=3, warmup=1),
         "bound_ms": b_ms, "bound_by": b_by,
         "library_ms": time_ms(torch, library, iters=10)}
    res["prefill"] = r
    log("kernels.flash_swa", shape=r["shape"],
        max_abs_err=f"{a['max_abs_err']:.3e}",
        element_limit_share=f"{a['limit_share']:.3f}",
        worst_element=json.dumps(a["worst"]), rms_err=f"{a['rms_err']:.3e}",
        rows_past_window_rms_err=f"{a['part_rms_err']:.3e}",
        rows_past_window_ref_rms=f"{a['part_ref_rms']:.3e}",
        tolerance=window_rule(True), sdpa_err=f"{sdpa_err:.3e}", **controls,
        ms=f"{r['ms']:.4f}", device_ms=f"{r['device_ms']:.4f}",
        plain_ms=f"{r['plain_ms']:.4f}", library_ms=f"{r['library_ms']:.4f}",
        bound_ms=f"{b_ms:.5f}", bound_by=b_by, pairs=pairs, bytes=nbytes,
        body="tensor cores")
    del q, k, v, qt, kt, vt, band, gap

    # ---- decode over the ring at the serving step
    B, T = 8, W
    qp = np.asarray([4523, 4223, 120, 250, 330, 399, 6000, 8191])
    kp = ring_positions(np, qp, T)
    wrapped = qp >= T
    q = t(rng.normal(size=(B, H, Dh)), torch.bfloat16)
    k = t(rng.normal(size=(B, T, Hkv, Dh)), torch.bfloat16)
    v = t(rng.normal(size=(B, T, Hkv, Dh)), torch.bfloat16)
    qp_d = torch.as_tensor(qp, dtype=torch.int32).to(dev)
    kp_d = torch.as_tensor(kp).to(dev)
    slots_d = torch.as_tensor(
        np.where(np.arange(T)[None] <= qp[:, None], np.arange(T)[None], -1),
        dtype=torch.int32).to(dev)

    def run():
        return da_ops.decode_attention(q, k, v, q_positions=qp_d,
                                       kv_positions=kp_d, window=W)

    def plain():
        return decode_attention_ref(q, k, v, q_positions=qp_d,
                                    kv_positions=kp_d, window=W)

    qs = q[:, :, None, :]                                  # (B,H,1,Dh)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)          # (B,Hkv,T,Dh)
    keep = (kp_d >= 0) & (qp_d[:, None] - kp_d < W)
    mask = keep[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(qs, kt, vt, attn_mask=mask,
                                              enable_gqa=True)

    ref = plain()
    wrapped_d = torch.as_tensor(wrapped).to(dev)
    s0, n0 = da_ops.split_launches, da_ops.launches
    a = window_agreement(torch, run(), ref, wrapped_d)
    assert da_ops.split_launches - s0 == da_ops.launches - n0 == 1, \
        "the ring's decode launch was not split"
    assert a["ok"], f"decode ring: {a}"
    controls = {}
    for name, kvp in (("positions_as_slots", slots_d),
                      ("last_tile_dropped", last_tile_dropped(torch, kp_d))):
        c = window_agreement(torch, decode_attention_ref(
            q, k, v, q_positions=qp_d, kv_positions=kvp, window=W), ref,
            wrapped_d)
        assert not c["ok"], f"the check cannot see {name}: {c}"
        controls[f"control_{name}"] = (
            f"max {c['max_abs_err']:.3e} ({c['limit_share']:.2f} of its "
            f"limit), RMS over the wrapped rows {c['part_rms_err']:.3e}: "
            "fails")
    n_keys = int(keep.sum().item())
    nbytes = 2 * q.numel() * 2 + 2 * n_keys * Hkv * Dh * 2 + 2 * B * H * 4 \
        + 4 * (kp_d.numel() + B)
    b_ms, b_by = bound(nbytes, 4 * Dh * H * n_keys, "bfloat16")
    r = {"shape": f"B={B},T={T},H={H},Hkv={Hkv},G={H // Hkv},Dh={Dh},"
                  f"window={W},bf16,positions={','.join(map(str, qp))}",
         "max_abs_err": a["max_abs_err"],
         "ms": time_ms(torch, run, iters=48),
         "device_ms": profile_calls(torch, run, 48)[1],
         "plain_ms": time_ms(torch, plain, iters=16),
         "bound_ms": b_ms, "bound_by": b_by,
         "library_ms": time_ms(torch, library, iters=48)}
    res["ring"] = r
    log("kernels.decode_ring", shape=r["shape"], wrapped_rows=int(
        wrapped.sum()), max_abs_err=f"{a['max_abs_err']:.3e}",
        rms_err=f"{a['rms_err']:.3e}",
        wrapped_rows_rms_err=f"{a['part_rms_err']:.3e}",
        wrapped_rows_ref_rms=f"{a['part_ref_rms']:.3e}",
        tolerance=window_rule(False),
        element_limit_share=f"{a['limit_share']:.3f}",
        worst_element=json.dumps(a["worst"]), **controls,
        ms=f"{r['ms']:.4f}", device_ms=f"{r['device_ms']:.4f}",
        plain_ms=f"{r['plain_ms']:.4f}", library_ms=f"{r['library_ms']:.4f}",
        bound_ms=f"{b_ms:.5f}", bound_by=b_by, valid_keys=n_keys,
        bytes=nbytes)
    return res


def kernels_flash_noncausal(torch, F, t, rng, fa_ops, flash_attention_ref):
    """The flash kernel non-causal, as whisper runs it: f32 and bf16 over
    padded keys, a row with no valid key and a row whose last, ragged tile
    is valid, then timed at the encoder (B=1, 1500 frames over 1500, 6
    heads, Dh 64) and the prefill cross-attention (64 prompt rows over
    1500 slots, the last 500 at -1), bf16, on the tensor cores, each held
    by ``bf16_agreement`` (a control with the last tile dropped must fail
    it).  Returns {call: numbers}."""
    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        B, Sq, Skv, H, Dh = 3, 48, 200, 6, 64
        q = t(rng.normal(size=(B, Sq, H, Dh)), dtype)
        k = t(rng.normal(size=(B, Skv, H, Dh)), dtype)
        v = t(rng.normal(size=(B, Skv, H, Dh)), dtype)
        qp = torch.arange(Sq, dtype=torch.int32, device=dev).expand(
            B, Sq).contiguous()
        kvp = torch.arange(Skv, dtype=torch.int32, device=dev).expand(
            B, Skv).contiguous()
        kvp[0, 130:] = -1                      # padded frames
        kvp[1] = -1                            # no valid key: mean(V)
        # row 2 keeps all 200 keys: its last tile (192-199) is ragged
        out = fa_ops.flash_attention(q, k, v, q_positions=qp,
                                     kv_positions=kvp, causal=False)
        ref = flash_attention_ref(q, k, v, q_positions=qp, kv_positions=kvp,
                                  causal=False)
        torch.testing.assert_close(out.float(), ref.float(),
                                   **op_tol(torch, dtype))
    res = {}
    for name, Sq, valid in (("encoder", 1500, 1500), ("cross", 64, 1000)):
        B, Skv, H, Dh = 1, 1500, 6, 64
        q = t(rng.normal(size=(B, Sq, H, Dh)), torch.bfloat16)
        k = t(rng.normal(size=(B, Skv, H, Dh)), torch.bfloat16)
        v = t(rng.normal(size=(B, Skv, H, Dh)), torch.bfloat16)
        qp = torch.arange(Sq, dtype=torch.int32, device=dev)[None]
        kvp = torch.arange(Skv, dtype=torch.int32, device=dev)[None]
        kvp = torch.where(kvp < valid, kvp, -1).to(torch.int32).contiguous()
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = (kvp >= 0)[:, None, None, :]

        def run():
            return fa_ops.flash_attention(q, k, v, q_positions=qp,
                                          kv_positions=kvp, causal=False)

        def plain():
            return flash_attention_ref(q, k, v, q_positions=qp,
                                       kv_positions=kvp, causal=False)

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=None if valid == Skv else mask)

        n_tc = fa_ops.tensor_core_launches
        ref = plain()
        err, rms_err, rms_ref, ok = bf16_agreement(torch, run(), ref)
        assert fa_ops.tensor_core_launches == n_tc + 1, \
            "non-causal flash missed the tensor cores"
        assert ok, f"non-causal flash {name}: {err}, RMS {rms_err}/{rms_ref}"
        control = flash_attention_ref(
            q, k, v, q_positions=qp,
            kv_positions=last_tile_dropped(torch, kvp), causal=False)
        c_err, c_rms, _, c_ok = bf16_agreement(torch, control, ref)
        assert not c_ok, "the check cannot see a dropped last key tile"
        nbytes = 2 * q.numel() * 2 + 2 * B * valid * H * Dh * 2 \
            + 4 * (Sq + Skv)
        b_ms, b_by = bound(nbytes, 4 * Sq * valid * H * Dh, "bfloat16")
        r = {"shape": f"B={B},Sq={Sq},Skv={Skv}({valid} valid),H=Hkv={H},"
                      f"Dh={Dh},causal=0,bf16",
             "max_abs_err": err, "ms": time_ms(torch, run),
             "device_ms": profile_calls(torch, run, 20)[1],
             "plain_ms": time_ms(torch, plain, iters=5, warmup=1),
             "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": time_ms(torch, library)}
        res[name] = r
        log("kernels.flash_noncausal", call=name, shape=r["shape"],
            max_abs_err=f"{err:.3e}", rms_err=f"{rms_err:.3e}",
            ref_rms=f"{rms_ref:.3e}", tolerance=BF16_AGREEMENT,
            control_last_tile_dropped=f"max {c_err:.3e}, RMS {c_rms:.3e}: "
            "fails", ms=f"{r['ms']:.4f}",
            device_ms=f"{r['device_ms']:.4f}",
            plain_ms=f"{r['plain_ms']:.4f}",
            library_ms=f"{r['library_ms']:.4f}", bound_ms=f"{b_ms:.5f}",
            bound_by=b_by, body="tensor cores",
            sweep="f32/bf16 over padded keys, a keyless row and a ragged "
            "last tile: ok")
    return res


def kernels_decode_cross(torch, F, t, rng, da_ops, decode_attention_ref,
                         layers):
    """Whisper's decode cross-attention through ``layers.attention`` (the
    one-token non-causal query the dispatcher hands the decode kernel at
    each row's last frame): B=8 rows over 1500 frame slots, 6 heads,
    Dh 64, bf16, ``enc_len`` 1500, 1000, 750 and 0 twice over.  It must
    equal the plain non-causal attention by ``bf16_agreement`` and give
    zeros on an ``enc_len`` 0 row; the call at the decode position (the
    fault repaired) and a call that drops each row's last key tile must
    fail that check; it is timed beside the plain version and SDPA.
    Returns its numbers."""
    dev = torch.device("cuda")
    B, T, H, Dh, NL = 8, 1500, 6, 64, 4
    enc_len = torch.tensor([1500, 1000, 750, 0] * 2, dtype=torch.int32,
                           device=dev)
    q = t(rng.normal(size=(B, 1, H, Dh)), torch.bfloat16)
    # four layers' cross KV cycled (74 MB, past the 50 MB L2)
    ks = t(rng.normal(size=(NL, B, T, H, Dh)), torch.bfloat16)
    vs = t(rng.normal(size=(NL, B, T, H, Dh)), torch.bfloat16)
    frames = torch.arange(T, dtype=torch.int32, device=dev)[None]
    kvp = torch.where(frames < enc_len[:, None], frames, -1).to(
        torch.int32).contiguous()
    pos = torch.full((B, 1), 37, dtype=torch.int32, device=dev)
    valid = enc_len > 0
    got = layers.attention(q, ks[0], vs[0], q_positions=pos,
                           kv_positions=kvp, causal=False, impl="cuda")
    plain_all = layers.attention(q, ks[0], vs[0], q_positions=pos,
                                 kv_positions=kvp, causal=False,
                                 impl="torch")
    err, rms_err, rms_ref, ok = bf16_agreement(torch, got[valid],
                                               plain_all[valid])
    assert ok, f"decode cross: {err}, RMS {rms_err}/{rms_ref}"
    assert torch.all(got[~valid] == 0), "an enc_len 0 row is not 0"
    at_pos = da_ops.decode_attention(q, ks[0], vs[0], q_positions=pos,
                                     kv_positions=kvp)
    uncorrected, u_rms, _, u_ok = bf16_agreement(torch, at_pos[valid],
                                                 plain_all[valid])
    dropped = layers.attention(q, ks[0], vs[0], q_positions=pos,
                               kv_positions=last_tile_dropped(torch, kvp),
                               causal=False, impl="torch")
    c_err, c_rms, _, c_ok = bf16_agreement(torch, dropped[valid],
                                           plain_all[valid])
    assert not u_ok and not c_ok, \
        "the check cannot see the decode position's mask or a dropped tile"
    rep = kvp.amax(dim=1, keepdim=True)
    layer = [0]

    def run():
        i = layer[0] = (layer[0] + 1) % NL
        return layers.attention(q, ks[i], vs[i], q_positions=pos,
                                kv_positions=kvp, causal=False, impl="cuda")

    def plain():
        i = layer[0] = (layer[0] + 1) % NL
        return decode_attention_ref(q[:, 0], ks[i], vs[i], q_positions=rep,
                                    kv_positions=kvp)

    qs = q.transpose(1, 2)                                 # (B,H,1,Dh)
    kt, vt = ks.transpose(2, 3), vs.transpose(2, 3)        # (NL,B,H,T,Dh)
    mask = (kvp >= 0)[:, None, None, :]

    def library():
        i = layer[0] = (layer[0] + 1) % NL
        return F.scaled_dot_product_attention(qs, kt[i], vt[i],
                                              attn_mask=mask)

    n_keys = int(enc_len.sum().item())
    nbytes = 2 * q.numel() * 2 + 2 * n_keys * H * Dh * 2 \
        + 4 * (kvp.numel() + B)
    b_ms, b_by = bound(nbytes, 4 * Dh * H * n_keys, "bfloat16")
    s0, n0 = da_ops.split_launches, da_ops.launches
    run()
    assert da_ops.split_launches - s0 == da_ops.launches - n0 == 1, \
        "the cross-attention decode launch was not split"
    res = {"shape": f"B={B},T={T},H=Hkv={H},G=1,Dh={Dh},bf16,enc_len="
                    "1500/1000/750/0 x2",
           "max_abs_err": err, "ms": time_ms(torch, run, iters=48),
           "device_ms": profile_calls(torch, run, 48)[1],
           "plain_ms": time_ms(torch, plain, iters=16),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": time_ms(torch, library, iters=48)}
    log("kernels.decode_cross", shape=res["shape"], max_abs_err=f"{err:.3e}",
        rms_err=f"{rms_err:.3e}", ref_rms=f"{rms_ref:.3e}",
        tolerance=BF16_AGREEMENT, enc_len_0_rows="zeros",
        uncorrected_position=f"max {uncorrected:.3e}, RMS {u_rms:.3e}: "
        "fails",
        control_last_tile_dropped=f"max {c_err:.3e}, RMS {c_rms:.3e}: fails",
        ms=f"{res['ms']:.4f}", device_ms=f"{res['device_ms']:.4f}",
        plain_ms=f"{res['plain_ms']:.4f}",
        library_ms=f"{res['library_ms']:.4f}", bound_ms=f"{b_ms:.5f}",
        bound_by=b_by, valid_keys=n_keys, bytes=nbytes,
        all_slots_kv_mb=f"{2 * B * T * H * Dh * 2 / 1e6:.1f}")
    return res


def word_prompts(np, tokenizer, vocab, seed, sizes):
    """{name: prompt} of ``sizes[name]`` random words (plus BOS)."""
    words = np.random.default_rng(seed)
    return {n: tokenizer.tokenize(" ".join(
        f"w{int(x)}" for x in words.integers(0, 10**6, k)), vocab)
        for n, k in sizes.items()}


def rows_view(torch, model, rows):
    """Stack dense cache rows along the model's batch axes, as the
    engine's ``_rebuild_view`` does."""
    axes = model.cache_batch_axes(rows[0])
    return {k: torch.cat([r[k] for r in rows], dim=ax)
            for k, ax in axes.items()}


def decode_parity(torch, model, view, tok):
    """One decode step of ``model`` under impl="cuda" and impl="torch"
    over copies of ``view``: (max abs difference, logit scale, same
    argmax)."""
    logits = {}
    for impl in ("cuda", "torch"):
        lg, _ = model.decode_step(tok, {k: v.clone() for k, v in
                                        view.items()}, impl=impl)
        assert lg.shape == (len(tok), model.cfg.padded_vocab) \
            and bool(torch.isfinite(lg).all()), impl
        logits[impl] = lg.float()
    diff = (logits["cuda"] - logits["torch"]).abs().max().item()
    scale = logits["torch"].abs().max().item()
    return diff, scale, torch.equal(logits["cuda"].argmax(-1),
                                    logits["torch"].argmax(-1))


def f32_copy(torch, build_model, eng):
    """A float32 copy of the engine's model (bf16 -> f32 is exact)."""
    m32 = build_model(eng.cfg.replace(dtype="float32"), device=eng.device)
    m32.load_state_dict(eng.model.state_dict())
    return m32


def parity_fields(diff, scale, same):
    return {"max_abs_diff": f"{diff:.4e}", "logit_scale": f"{scale:.4e}",
            "same_argmax": same}


def vlm_phases(torch, np, get_config, tokenizer, InferenceEngine,
               build_model, fa_ops, pd_ops, da_ops, plain_calls):
    """internvl2-2b at full width in bf16 (random weights and patch
    embeddings from seed 0 and 7, engine defaults): four requests with 256
    patch embeddings each and two text-only ones sharing a prefix,
    through flash prefill and the fused paged decode; the CUDA step
    against the plain step (bf16, and a float32 copy) on a live step of
    all six rows, the patch requests among them; the paged arm against
    the dense view on a float32 copy cut in depth.  Returns the kernels'
    launches."""
    cfg = get_config("internvl2-2b")
    eng = InferenceEngine(cfg, seed=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before_gib = torch.cuda.memory_allocated() / 2**30
    load_s = eng.load()
    prompts, n_shared = family_prompts(
        np, tokenizer, cfg.vocab_size, 7,
        {"shared": 100, "text_a": (80, True), "text_b": (150, True),
         "img_a": (120, False), "img_b": (250, False),
         "img_c": (180, False), "img_d": (99, False)})
    assert all(100 <= len(p) <= 300 for p in prompts.values())
    rng = np.random.default_rng(7)
    P = cfg.num_patches
    # the stub frontend's output, at the token embeddings' scale
    extras = {n: {"patch_embeds": (0.02 * rng.normal(
        size=(1, P, cfg.d_model))).astype(np.float32)}
        for n in prompts if n.startswith("img")}
    max_new = 32
    kinds = []
    outs, launches, step_s, admit_s, run_s = serve_checked(
        torch, eng, prompts, max_new, (tuple(prompts), ()), fa_ops, pd_ops,
        plain_calls, extras=extras, kinds=kinds)
    st = eng.stats
    assert st.prefix_hits >= 1, st.as_dict()
    assert launches["paged_split"] == launches["paged_decode_attention"], \
        "a paged launch was not split"
    assert launches["flash_attention"] == cfg.num_layers * len(admit_s)
    text_tokens = sum(len(p) for p in prompts.values())
    assert st.prefill_tokens + st.prefill_tokens_saved \
        == text_tokens + P * len(extras), st.as_dict()
    peak = torch.cuda.max_memory_allocated() / 2**30
    patch_ms = [round(1e3 * s, 3) for s, k in zip(admit_s, kinds) if k]
    text_ms = [round(1e3 * s, 3) for s, k in zip(admit_s, kinds) if not k]
    decode_s = sum(step_s)
    log("vlm.run", model=f"internvl2-2b(full width, {cfg.num_layers} layers, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, Dh "
        f"{cfg.resolved_head_dim}, untied head)", dtype="bf16",
        params_gb=f"{eng.param_bytes() / 1e9:.3f}", requests=len(outs),
        with_patches=len(extras), patches_each=P, tokens_each=max_new,
        shared_prefix=n_shared, prefix_hits=st.prefix_hits,
        peak_batch=st.peak_batch, decode_steps=len(step_s),
        prefill_tokens=st.prefill_tokens, load_s=f"{load_s:.3f}",
        run_s=f"{run_s:.3f}",
        mean_step_ms=f"{1e3 * decode_s / len(step_s):.3f}",
        prefill_ms_patch_requests=json.dumps(patch_ms),
        prefill_ms_text_requests=json.dumps(text_ms),
        decode_tok_per_s=f"{st.decode_tokens / decode_s:.2f}",
        max_memory_allocated_gib=f"{peak:.3f}",
        allocated_before_load_gib=f"{before_gib:.3f}",
        flash_launches=launches["flash_attention"],
        flash_tensor_core_launches=launches["flash_tensor_core"],
        paged_launches=launches["paged_decode_attention"],
        paged_split_launches=launches["paged_split"],
        paged_fused_launches=launches["paged_fused"],
        widest_table_pages=st.widest_decode_table,
        plain_calls=launches["plain_calls"])

    # the CUDA step against the plain step at full depth, on the engine's
    # own step once its batch holds the four patch requests (which never
    # stay warm): the six requests served again, not counted
    m32 = f32_copy(torch, build_model, eng)
    got, n_rows, n_patch, row_lens, table_pages = live_step_parity(
        torch, np, eng, {"bf16": eng.model, "float32": m32}, len(extras),
        lambda: serve_requests(eng, prompts, max_new, tuple(prompts),
                               extras=extras))
    del m32
    parity = {arm: parity_fields(*r) for arm, r in got.items()}
    # where a call's time goes: a decode step over the warm rows (padded
    # to 8) and a cold chunk prefill of a text prompt
    fields = {}
    for kind, (call, (wall, busy, top)) in zip(
            ("decode", "prefill"),
            profile_engine(torch, np, eng, prompts["text_b"],
                           max_new).items()):
        fields.update({f"{kind}_call": call, f"{kind}_wall_ms": f"{wall:.3f}",
                       f"{kind}_device_busy_ms": f"{busy:.3f}",
                       f"{kind}_busy_share": f"{busy / wall:.3f}",
                       f"{kind}_top_kernels_ms": json.dumps(top)})
    log("vlm.profile", **fields)
    log("vlm.step_parity", rows=n_rows, patch_rows=n_patch,
        row_lengths=json.dumps(row_lens), table_pages=table_pages,
        tolerance="bf16 5e-2*scale, float32 1e-3*scale",
        arms=json.dumps(parity))
    for arm, limit in (("bf16", 5e-2), ("float32", 1e-3)):
        a = parity[arm]
        assert float(a["max_abs_diff"]) <= limit * float(a["logit_scale"]), a

    # a float32 copy cut in depth: the paged path against the dense view
    cut = cfg.replace(dtype="float32", num_layers=CUT_LAYERS)
    sd = cut_copy(eng, CUT_LAYERS)
    free_engine(torch, eng)
    arms = {}
    da_ops.reset_counts()
    for paged in (True, False):
        e = InferenceEngine(cut, seed=0, paged_decode=paged)
        e.load(sd)
        arms[paged] = serve_requests(e, prompts, max_new, tuple(prompts),
                                     extras=extras)
        free_engine(torch, e)
    launches["decode_attention_dense_view"] = da_ops.launches
    log("vlm.dense_view", float32_layers=CUT_LAYERS, requests=len(prompts),
        with_patches=len(extras), paged_vs_dense_view=(
            "equal" if arms[True] == arms[False] else "differ"),
        dense_view_decode_launches=da_ops.launches,
        first_differing_token=json.dumps(
            {n: first_difference(arms[True][n], arms[False][n])
             for n in prompts}))
    assert arms[True] == arms[False], "paged and dense-view tokens differ"
    assert da_ops.launches > 0, "the dense view launched no decode kernel"
    return launches


def ssm_phases(torch, np, get_config, tokenizer, InferenceEngine,
               build_model, fa_ops, pd_ops, da_ops, plain_calls):
    """xlstm-350m at full width in bf16 (random weights from seed 0,
    engine defaults) through the dense-row path: six requests of 64-256
    tokens, its profile, prefill plus decode against the teacher-forced
    forward on a float32 copy, and batch invariance.  It launches no
    attention kernel: the recurrences are eager PyTorch."""
    dev = torch.device("cuda")
    cfg = get_config("xlstm-350m")
    eng = InferenceEngine(cfg, seed=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    load_s = eng.load()
    prompts = word_prompts(np, tokenizer, cfg.vocab_size, 9,
                           {"a": 63, "b": 95, "c": 127, "d": 159, "e": 200,
                            "f": 255})
    assert all(64 <= len(p) <= 256 for p in prompts.values())
    max_new = 32
    outs, launches, step_s, admit_s, run_s = serve_dense(
        torch, eng, prompts, max_new, (tuple(prompts), ()), fa_ops, da_ops,
        pd_ops, plain_calls)
    kernel_launches = launches["flash_attention"] \
        + launches["decode_attention"]
    st = eng.stats
    assert kernel_launches == 0, launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_tok = sum(len(p) for p in prompts.values())
    decode_s = sum(step_s)

    # where a call's time goes: the 64-token prefill, and a decode step
    # over a B=8 view of that request's state
    model = eng.model
    toks = torch.as_tensor([prompts["a"]], dtype=torch.int32, device=dev)
    _, row = model.prefill(toks)
    view = rows_view(torch, model, [row] * 8)
    tok8 = torch.arange(8, dtype=torch.int32, device=dev) + 11
    prof = {}
    for what, fn, n in (
            (f"prefill(S={toks.shape[1]})", lambda: model.prefill(toks), 1),
            ("decode_step(B=8)", lambda: model.decode_step(tok8, view), 3)):
        wall, busy, top = profile_calls(torch, fn, n)
        prof[what] = {"wall_ms": f"{wall:.3f}",
                      "device_busy_ms": f"{busy:.3f}",
                      "busy_share": f"{busy / wall:.3f}",
                      "top_kernels_ms": top}
    del view, row
    log("ssm.run", model=f"xlstm-350m(full width, {cfg.num_layers // 2} "
        f"mLSTM/sLSTM pairs, d_model {cfg.d_model}, {cfg.num_heads} heads "
        f"of {cfg.resolved_head_dim})", dtype="bf16",
        params_gb=f"{eng.param_bytes() / 1e9:.3f}", requests=len(outs),
        prompt_tokens=json.dumps({n: len(p) for n, p in prompts.items()}),
        tokens_each=max_new, peak_batch=st.peak_batch,
        view_rebuilds=st.view_rebuilds, decode_steps=len(step_s),
        load_s=f"{load_s:.3f}", run_s=f"{run_s:.3f}",
        mean_step_ms=f"{1e3 * decode_s / len(step_s):.3f}",
        prefill_ms_per_request=f"{1e3 * sum(admit_s) / len(admit_s):.3f}",
        prefill_ms_per_token=f"{1e3 * sum(admit_s) / n_tok:.3f}",
        decode_tok_per_s=f"{st.decode_tokens / decode_s:.2f}",
        max_memory_allocated_gib=f"{peak:.3f}",
        attention_kernel_launches=kernel_launches,
        plain_calls=launches["plain_calls"], kv_pages="none",
        profile=json.dumps(prof))

    # prefill plus decode against the teacher-forced forward, float32 copy
    m32 = f32_copy(torch, build_model, eng)
    n_dec = 8
    seq = torch.as_tensor([prompts["a"] + outs["a"][:n_dec]],
                          dtype=torch.int32, device=dev)
    S = len(prompts["a"])
    full, _ = m32(seq)
    logits, cache = m32.prefill(seq[:, :S])
    got = [logits[0]]
    for i in range(n_dec):
        lg, cache = m32.decode_step(seq[:, S + i], cache)
        got.append(lg[0])
    ref = full[0, S - 1:]
    diff = (torch.stack(got) - ref).abs().max().item()
    scale = ref.abs().max().item()
    log("ssm.forward_parity", dtype="float32", prompt=S, decoded=n_dec,
        positions_checked=n_dec + 1, max_abs_diff=f"{diff:.4e}",
        logit_scale=f"{scale:.4e}", tolerance="1e-3*scale")
    assert diff <= 1e-3 * scale, (diff, scale)
    del m32, full, cache

    # batch invariance: request a alone, bf16 logged, float32 asserted
    e32, _ = batch_invariance(torch, InferenceEngine, eng, "ssm", prompts,
                              outs, "a", max_new, (tuple(prompts), ()))
    free_engine(torch, e32, eng)


AUDIO_FRAMES = {"a": 1500, "b": 1500, "c": 1000, "d": 1000, "e": 750,
                "f": 300}


def audio_phases(torch, np, get_config, tokenizer, InferenceEngine,
                 build_model, fa_ops, pd_ops, da_ops, plain_calls):
    """whisper-tiny at full width in bf16 (random weights and frames from
    seed 0 and 8, engine defaults) through the dense-row path: six
    requests of 4-64 prompt tokens with 1500 to 300 frames each, so rows
    padded to 1500 frames share a batch: flash for the encoder and the
    decoder's self- and cross-attention, the decode kernel for both in
    each step; the CUDA step against the plain step; batch invariance.
    Returns the kernels' launches."""
    dev = torch.device("cuda")
    cfg = get_config("whisper-tiny")
    eng = InferenceEngine(cfg, seed=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    load_s = eng.load()
    prompts = word_prompts(np, tokenizer, cfg.vocab_size, 8,
                           {"a": 15, "b": 3, "c": 63, "d": 31, "e": 7,
                            "f": 47})
    assert all(4 <= len(p) <= 64 for p in prompts.values())
    rng = np.random.default_rng(8)
    extras = {n: {"frames": rng.normal(size=(1, T, cfg.d_model)).astype(
        np.float32)} for n, T in AUDIO_FRAMES.items()}
    max_new = 32
    requests = (tuple(prompts), ())
    outs, launches, step_s, admit_s, run_s = serve_dense(
        torch, eng, prompts, max_new, requests, fa_ops, da_ops, pd_ops,
        plain_calls, extras=extras)
    st = eng.stats
    n_steps, admitted = len(step_s), len(admit_s)
    peak = torch.cuda.max_memory_allocated() / 2**30
    decode_s = sum(step_s)
    log("audio.run", model=f"whisper-tiny(full width, {cfg.enc_layers} "
        f"encoder + {cfg.num_layers} decoder layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads, Dh {cfg.resolved_head_dim})", dtype="bf16",
        params_gb=f"{eng.param_bytes() / 1e9:.4f}", requests=len(outs),
        frames=json.dumps(AUDIO_FRAMES),
        prompt_tokens=json.dumps({n: len(p) for n, p in prompts.items()}),
        tokens_each=max_new, peak_batch=st.peak_batch,
        view_rebuilds=st.view_rebuilds, decode_steps=n_steps,
        load_s=f"{load_s:.3f}", run_s=f"{run_s:.3f}",
        mean_step_ms=f"{1e3 * decode_s / n_steps:.3f}",
        prefill_ms_per_request=f"{1e3 * sum(admit_s) / admitted:.3f}",
        decode_tok_per_s=f"{st.decode_tokens / decode_s:.2f}",
        max_memory_allocated_gib=f"{peak:.3f}", launches=json.dumps(launches))
    # per request: the encoder's layers, then self- and cross-attention in
    # each decoder layer; per step: self- and cross-attention decode
    assert launches["flash_attention"] \
        == admitted * (cfg.enc_layers + 2 * cfg.num_layers), launches
    assert launches["decode_attention"] == n_steps * 2 * cfg.num_layers, \
        (launches, n_steps)

    # the CUDA step against the plain step over a view of four rows with
    # 1500, 1000, 750 and 300 frames
    model = eng.model
    rows = []
    for n in ("a", "c", "e", "f"):
        toks = torch.as_tensor([prompts[n]], dtype=torch.int32, device=dev)
        _, cache = model.prefill(toks, eng._extra(extras[n]["frames"]))
        rows.append(model.extend_cache(cache,
                                       eng.max_seq_len - toks.shape[1]))
    view = rows_view(torch, model, rows)
    del rows
    tok4 = torch.arange(4, dtype=torch.int32, device=dev) + 11
    wall, busy, top = profile_calls(
        torch, lambda: model.decode_step(tok4, view), 5)
    log("audio.profile", call="decode_step(B=4, 1500 frame slots)",
        wall_ms_per_call=f"{wall:.3f}", device_busy_ms_per_call=f"{busy:.3f}",
        device_busy_share=f"{busy / wall:.3f}",
        top_kernels_ms_per_call=json.dumps(top))
    parity = {"bf16": parity_fields(*decode_parity(torch, model, view,
                                                   tok4))}
    m32 = f32_copy(torch, build_model, eng)
    view32 = {k: (v.float() if v.is_floating_point() else v)
              for k, v in view.items()}
    parity["float32"] = parity_fields(*decode_parity(torch, m32, view32,
                                                     tok4))
    del view, view32, m32
    log("audio.step_parity", rows=4, frames="1500/1000/750/300",
        tolerance="bf16 5e-2*scale, float32 1e-3*scale",
        arms=json.dumps(parity))
    for arm, limit in (("bf16", 5e-2), ("float32", 1e-3)):
        a = parity[arm]
        assert float(a["max_abs_diff"]) <= limit * float(a["logit_scale"]), a

    # batch invariance: the 300-frame request alone and in the batch;
    # padded frames add exact zeros, so float32 is asserted
    e32, _ = batch_invariance(torch, InferenceEngine, eng, "audio", prompts,
                              outs, "f", max_new, requests, extras=extras)
    free_engine(torch, e32, eng)
    return launches


# ---------------------------------------------------------------------------
# latent attention: DeepSeek-V2 on the paged path
# ---------------------------------------------------------------------------

# the dsv2.halo_nodes cell's shapes: its rows, its page and its longest
# call (a 512-token prompt and 96 new tokens)
MLA_ROWS, MLA_CONTEXT, MLA_PAGE = 768, 608, 8


def latent_tolerance(torch, ref_fn, q, pool, pt, lengths, scale, v_dim):
    """The plain version's output in float32 and the rule a bfloat16
    result is held to, the card test's (tests/test_torch_deepseek_v2.py):
    2e-3 + 8e-3 |ref| + 3.125e-2 sqrt(sum_j p_j^2 v_j^2), the last the
    noise of probabilities rounded to bfloat16 for the value product."""
    ref = ref_fn(q.float(), pool, pt, lengths, scale=scale,
                 v_dim=v_dim).float()
    B = pt.shape[0]
    keys = pool[pt.long()].reshape(B, -1, pool.shape[-1])
    logits = torch.einsum("bhd,btd->bht", q.float(), keys) * scale
    t = torch.arange(keys.shape[1], device=q.device)
    valid = t[None, :] <= lengths[:, None].long()
    p = torch.softmax(logits.masked_fill(~valid[:, None], float("-inf")), -1)
    p = torch.nan_to_num(p)
    noise = torch.einsum("bht,btd->bhd", p.square(),
                         keys[..., :v_dim].square()).sqrt()
    return ref, 2e-3 + 8e-3 * ref.abs() + 3.125e-2 * noise


def kernels_latent(torch, ld_ops, latent_decode_attention_ref, scale):
    """The latent decode kernel against its plain version at the cell's
    shapes: 768 rows of 128 heads over the 576-wide latent (values its
    first 512), pages of 8 in a shuffled f32 pool, contexts 1 to 608 and a
    padding row (0); each row's last key dropped as the control that must
    fail; then timed beside the plain version, with its bound from the
    valid keys.  Returns its kernels entry."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    B, H, ps = MLA_ROWS, 128, MLA_PAGE
    D, dv = ld_ops.LATENT_DIM, ld_ops.V_DIM
    n_pages = -(-MLA_CONTEXT // ps)
    lengths = torch.randint(0, MLA_CONTEXT, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
    lengths[0], lengths[1], lengths[2] = -1, MLA_CONTEXT - 1, 0
    P = B * n_pages + 3
    pt = torch.randperm(P, generator=gen, device=dev)[:B * n_pages] \
        .view(B, n_pages).to(torch.int32)
    # the engine's latents are bf16 numbers in an f32 pool
    pool = torch.randn((P, ps, D), generator=gen, device=dev) \
        .bfloat16().float()
    q = (0.5 * torch.randn((B, H, D), generator=gen, device=dev)).bfloat16()

    def run(lens=lengths):
        return ld_ops.latent_decode_attention(q, pool, pt, lens, scale=scale,
                                              v_dim=dv)

    def plain():
        return latent_decode_attention_ref(q, pool, pt, lengths, scale=scale,
                                           v_dim=dv)

    n0 = ld_ops.launches
    out = run()
    torch.cuda.synchronize()
    assert ld_ops.launches == n0 + 1 and out.dtype == torch.bfloat16
    ref, tol = latent_tolerance(torch, latent_decode_attention_ref, q, pool,
                                pt, lengths, scale, dv)
    diff = (out.float() - ref).abs()
    assert bool((diff <= tol).all()), \
        f"latent kernel off the rule by {(diff - tol).max().item():.3e}"
    assert bool((out[0] == 0).all()), "the padding row is not 0"
    rms = ((out.float() - ref).square().mean().sqrt()
           / ref.square().mean().sqrt()).item()
    short = torch.where(lengths > 0, lengths - 1, lengths)
    assert bool(((run(short).float() - ref).abs() > tol).any()), \
        "the control (each row's last key dropped) passed"
    err = diff.max().item()
    del ref, tol, diff
    live = lengths[lengths >= 0]
    keys = int((live.long() + 1).sum().item())
    nbytes = keys * D * 4 + live.numel() * H * (D + dv) * 2
    b_ms, b_by = bound(nbytes, 2 * H * (D + dv) * keys, "bfloat16")
    entry = {
        "name": "latent_decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/latent_decode_attention.cu",
        "replaces": "none: the JAX package has no latent attention",
        "launches": None, "max_abs_err": err,
        "ms": time_ms(torch, run, iters=20),
        "device_ms": profile_calls(torch, run, 20)[1],
        "plain_ms": time_ms(torch, plain, iters=5, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "library_note": "no single PyTorch call takes a paged latent pool"}
    log("kernels.latent_decode",
        shape=f"B={B},H={H},D={D},v={dv},page={ps},contexts=1..{MLA_CONTEXT},"
        f"bf16 q,f32 pool,valid_keys={keys}", vs_plain="ok",
        tolerance="2e-3+8e-3|ref|+3.125e-2*sqrt(sum p^2 v^2)",
        max_abs_err=f"{err:.3e}", rms_err_share=f"{rms:.3e}",
        padding_row=0, control_last_key_dropped="fails",
        ms=f"{entry['ms']:.4f}", device_ms=f"{entry['device_ms']:.4f}",
        plain_ms=f"{entry['plain_ms']:.4f}", bound_ms=f"{b_ms:.5f}",
        bound_by=b_by, bytes=nbytes,
        share_of_bound=f"{100 * b_ms / entry['device_ms']:.2f}%")
    return entry


def mla_phases(torch, np, tokenizer, InferenceEngine, fa_ops, pd_ops,
               ld_ops, plain_calls):
    """DeepSeek-V2 as the dsv2.halo_nodes cell's card holds it (full
    width, 30 of 60 layers, experts 0-19 of 160; random weights from seed
    0, engine defaults) served through the engine: a shared prefix with a
    copy-on-write partial page, cold prompts and a request admitted
    mid-decode, with every launch count set to 0 just before the run and
    read just after: one flash launch a layer a prefill call (all on the
    tensor cores, at Dh 256), one latent launch a layer a decode step, no
    paged launch and no plain version; the model's counters
    (``EngineStats.probes``) beside them.  Returns the launches."""
    from repro_torch.configs.deepseek_v2 import CONFIG as cfg
    eng = InferenceEngine(cfg, seed=0)
    torch.cuda.empty_cache()
    load_s = eng.load()
    torch.cuda.empty_cache()
    model, n_layers = eng.model, cfg.num_layers
    n_moe = n_layers - cfg.moe.first_dense_layers
    calls = {"prefill": 0, "decode": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    model.prefill_with_cache = counted("prefill", model.prefill_with_cache)
    model.paged_decode_step = counted("decode", model.paged_decode_step)
    prompts, n_shared = family_prompts(
        np, tokenizer, cfg.vocab_size, 31,
        {"shared": 100, "share_a": (80, True), "share_b": (190, True),
         "cold_c": (250, False), "cold_d": (120, False)})
    max_new = 16
    n_plain = plain_calls["n"]
    for ops in (fa_ops, pd_ops, ld_ops):
        ops.reset_counts()
    before = eng.stats.as_dict()
    t_run = time.perf_counter()
    outs, ran = device_kernels(torch, lambda: serve_requests(
        eng, prompts, max_new, ("share_a", "cold_c", "cold_d"),
        ("share_b",)))
    run_s = time.perf_counter() - t_run
    launches = {"flash_attention": fa_ops.launches,
                "flash_tensor_core": fa_ops.tensor_core_launches,
                "latent_decode_attention": ld_ops.launches,
                "latent_ran": kernels_named(ran, LATENT_KERNEL),
                "paged_decode_attention": pd_ops.launches,
                "plain_calls": plain_calls["n"] - n_plain}
    after = eng.stats.as_dict()
    probes = {k: after[k] - before[k] for k in
              ("expert_slots_held", "moe_layer_calls",
               "latent_decode_launches", "decode_graph_replays",
               "decode_graph_captures")}
    assert all(len(o) == max_new for o in outs.values()), "short output"
    assert after["prefix_hits"] >= 1, after
    assert calls["prefill"] > 0 and calls["decode"] > 0, calls
    assert launches["flash_attention"] == n_layers * calls["prefill"], \
        (launches, calls)
    assert launches["flash_tensor_core"] == launches["flash_attention"], \
        "a bf16 flash launch missed the tensor cores"
    assert launches["latent_ran"] == n_layers * calls["decode"] \
        == launches["latent_decode_attention"], (launches, calls)
    assert probes["latent_decode_launches"] == \
        launches["latent_decode_attention"], probes
    assert probes["moe_layer_calls"] == \
        n_moe * (calls["prefill"] + calls["decode"]), (probes, calls)
    assert launches["paged_decode_attention"] == 0 \
        and kernels_named(ran, PAGED_KERNEL) == 0, launches
    assert launches["plain_calls"] == 0, \
        "a plain version ran on the CUDA path"
    log("mla.run", model=f"{cfg.name}(full width, {n_layers} of 60 layers, "
        f"{cfg.routing.held_count} of {cfg.moe.num_experts} experts held, "
        f"{cfg.num_heads} heads, latent "
        f"{cfg.mla.kv_lora_rank}+{cfg.mla.qk_rope_head_dim})", dtype="bf16",
        params_gb=f"{eng.param_bytes() / 1e9:.3f}", load_s=f"{load_s:.3f}",
        requests=len(outs), tokens_each=max_new, shared_prefix=n_shared,
        prefix_hits=after["prefix_hits"], prefill_calls=calls["prefill"],
        decode_steps=calls["decode"], run_s=f"{run_s:.3f}",
        flash_launches=launches["flash_attention"],
        flash_tensor_core_launches=launches["flash_tensor_core"],
        latent_launches=launches["latent_decode_attention"],
        latent_kernels_ran=launches["latent_ran"],
        paged_launches=launches["paged_decode_attention"],
        plain_calls=launches["plain_calls"],
        expert_slots_held=probes["expert_slots_held"],
        moe_layer_calls=probes["moe_layer_calls"],
        decode_graph_replays=probes["decode_graph_replays"],
        decode_graph_captures=probes["decode_graph_captures"])
    free_engine(torch, eng)
    return launches


# --------------------------------------------------------------- training

def flash_bwd_pairs(torch, qp, kvp, causal, window):
    """Valid (query, key) pairs of these positions, summed over the batch
    (the same for every head)."""
    q, k = qp[:, :, None], kvp[:, None, :]
    mask = (k >= 0).expand(-1, qp.shape[1], -1)
    if causal:
        mask = mask & (k <= q)
    if window:
        mask = mask & (k > q - window)
    return int(mask.sum())


def f32_agreement(torch, out, ref, tol=1e-4):
    """(max abs error, the reference's largest magnitude, whether the error
    is within ``tol`` of it)."""
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    return err, scale, err <= tol * max(scale, 1e-6)


# what the kernels line keeps of each [kernels.flash_bwd] shape
BWD_KEYS = ("shape", "body", "max_abs_err", "ms", "device_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "queued_ms",
            "library_queued_ms")
# name, B, Sq, Skv, H, Hkv, Dh, causal, window, valid keys
FLASH_BWD_SHAPES = (
    ("qwen3", 8, 512, 512, 16, 8, 128, True, 0, 512),
    ("hybrid", 4, 512, 512, 10, 1, 256, True, 2048, 512),
    ("hybrid_window128", 4, 512, 512, 10, 1, 256, True, 128, 512),
    ("whisper_encoder", 8, 1500, 1500, 6, 6, 64, False, 0, 1500),
    ("whisper_cross", 8, 128, 1500, 6, 6, 64, False, 0, 1000),
)


def kernels_flash_bwd(torch, F, fa_ops, flash_attention_bwd_ref,
                      flash_attention_lse_ref):
    """The flash backward at the training paths' shapes: dQ, dK, dV through
    the autograd Function (the forward kernel with its log-sum-exp, then
    the backward kernel) against ``flash_attention_bwd_ref`` on the same
    inputs, in f32 (within 1e-4 of each gradient's scale) and bf16
    (``bf16_agreement``); the forward's lse against its plain version; a
    control with the last valid KV tile's dV dropped must fail; two calls
    on the same inputs give the same bits; every bf16 shape takes the
    tensor cores; a row with no valid key gets dQ = 0, adds nothing to dK
    and sends dO/Skv to every key's dV.  Timed in bf16 (events and the
    profiler's device time) beside the plain version and SDPA's backward
    (never called by the port), both also with their calls queued behind a
    sleep kernel (``queued_ms``), since SDPA's host work through autograd
    can outlast its device work.  Returns {shape: numbers}."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    res = {}
    for (name, B, Sq, Skv, H, Hkv, Dh, causal, window,
         valid) in FLASH_BWD_SHAPES:
        def rand(*shape):
            return torch.randn(*shape, generator=gen, device=dev)

        x32 = (rand(B, Sq, H, Dh), rand(B, Skv, Hkv, Dh),
               rand(B, Skv, Hkv, Dh), rand(B, Sq, H, Dh))
        qp = torch.arange(Sq, dtype=torch.int32, device=dev).expand(
            B, Sq).contiguous()
        if causal:                          # queries at the end of the keys
            qp = qp + (Skv - Sq)
        kvp = torch.arange(Skv, dtype=torch.int32, device=dev)[None]
        kvp = torch.where(kvp < valid, kvp, -1).expand(
            B, Skv).to(torch.int32).contiguous()
        kw = dict(q_positions=qp, kv_positions=kvp, causal=causal,
                  window=window)
        r = {"shape": f"B={B},Sq={Sq},Skv={Skv}({valid} valid),H={H},"
                      f"Hkv={Hkv},Dh={Dh},causal={int(causal)},"
                      f"window={window}"}
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (t.to(dtype) for t in x32)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            n_bwd = fa_ops.bwd_launches
            fa_ops.flash_attention(*leaves, **kw).backward(do)
            assert fa_ops.bwd_launches == n_bwd + 1
            got = [t.grad for t in leaves]
            ref = flash_attention_bwd_ref(q, k, v, do, **kw)
            _, lse = fa_ops.flash_attention_lse(q, k, v, **kw)
            lse_err = (lse - flash_attention_lse_ref(q, k, **kw)).abs() \
                .max().item()
            assert lse_err <= 1e-3, (name, dtype, lse_err)
            tag = "f32" if dtype == torch.float32 else "bf16"
            for n, a, b in zip("qkv", got, ref):
                if dtype == torch.float32:
                    err, scale, ok = f32_agreement(torch, a, b)
                    r[f"d{n}_f32"] = f"max {err:.3e} of scale {scale:.3e}"
                else:
                    err, rms_err, rms_ref, ok = bf16_agreement(torch, a, b)
                    r[f"d{n}_bf16"] = (f"max {err:.3e}, RMS {rms_err:.3e} "
                                       f"of {rms_ref:.3e}")
                    r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
                assert ok, (name, tag, n, r)
            r[f"lse_err_{tag}"] = lse_err
            # determinism: two calls on the same inputs, bitwise equal
            first = fa_ops.flash_attention_bwd(q, k, v, do, lse, **kw)
            second = fa_ops.flash_attention_bwd(q, k, v, do, lse, **kw)
            assert all(torch.equal(a, b) for a, b in zip(first, second)), \
                (name, tag, "two calls differ")
            r[f"deterministic_{tag}"] = "bitwise"
            del first, second
        # control: the last valid KV tile's dV dropped
        dv_c = got[2].clone()
        dv_c[:, (valid - 1) // 64 * 64:valid] = 0
        c_err, c_rms, _, c_ok = bf16_agreement(torch, dv_c, ref[2])
        assert not c_ok, (name, "the check cannot see a dropped dV tile")
        r["control_dv_last_tile_dropped"] = \
            f"max {c_err:.3e}, RMS {c_rms:.3e}: fails"

        q, k, v, do = (t.to(torch.bfloat16) for t in x32)
        _, lse = fa_ops.flash_attention_lse(q, k, v, **kw)

        def run():
            return fa_ops.flash_attention_bwd(q, k, v, do, lse, **kw)

        def plain():
            return flash_attention_bwd_ref(q, k, v, do, **kw)

        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        mask = None
        if window or valid < Skv:
            qq, kk = qp[:, None, :, None], kvp[:, None, None, :]
            mask = (kk >= 0) & (kk <= qq) if causal else kk >= 0
            if window:
                mask = mask & (kk > qq - window)
        o = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=H != Hkv)
        dot = do.transpose(1, 2)

        def library():
            return torch.autograd.grad(o, (qt, kt, vt), dot,
                                       retain_graph=True)

        pairs = flash_bwd_pairs(torch, qp, kvp, causal, window)
        esz = 2
        nbytes = 3 * q.numel() * esz + 4 * k.numel() * esz \
            + 4 * B * H * Sq + 4 * (B * Sq + B * Skv)
        b_ms, b_by = bound(nbytes, 10 * Dh * H * pairs, "bfloat16")
        r.update({"ms": time_ms(torch, run, iters=10),
                  "device_ms": profile_calls(torch, run, 5)[1],
                  "plain_ms": time_ms(torch, plain, iters=2, warmup=1),
                  "bound_ms": b_ms, "bound_by": b_by,
                  "library_ms": time_ms(torch, library, iters=10),
                  "queued_ms": queued_ms(torch, run),
                  "library_queued_ms": queued_ms(torch, library)})
        del o, qt, kt, vt
        res[name] = r
        r["body"] = "tensor cores" if fa_ops.bwd_uses_tensor_cores(
            torch.bfloat16, Dh) else "CUDA cores"
        assert r["body"] == "tensor cores", (name, r["body"])
        r["head_split"] = fa_ops.bwd_head_split(
            B, Skv, Hkv, H // Hkv, torch.cuda.get_device_properties(
                dev).multi_processor_count)
        log("kernels.flash_bwd", call=name,
            **{k_: (f"{v_:.5g}" if isinstance(v_, float) else v_)
               for k_, v_ in r.items()},
            tolerance=f"f32 1e-4*scale; bf16 {BF16_AGREEMENT}",
            kernels="bf16: metadata, D, dK/dV + dQ in one launch, the "
                    "splits' sum when split; f32: D, dK/dV, dQ on the CUDA "
                    "cores")
        torch.cuda.empty_cache()

    # a row with no valid key at qwen3's width: only it carries dO
    B, S, H, Hkv, Dh = 2, 128, 16, 8, 128
    q, k, v, do = (torch.randn(*s, generator=gen, device=dev).to(
        torch.bfloat16) for s in ((B, S, H, Dh), (B, S, Hkv, Dh),
                                   (B, S, Hkv, Dh), (B, S, H, Dh)))
    qp = torch.arange(S, dtype=torch.int32, device=dev).expand(
        B, S).contiguous()
    qp[0, 5] = -1
    do = torch.where(torch.arange(B * S, device=dev).reshape(B, S, 1, 1)
                     == 5, do, torch.zeros_like(do))
    kw = dict(q_positions=qp, kv_positions=qp.clone(), causal=True)
    _, lse = fa_ops.flash_attention_lse(q, k, v, **kw)
    assert lse[0, :, 5].eq(-1e30).all(), "a keyless row's lse mark"
    dq, dk, dv = fa_ops.flash_attention_bwd(q, k, v, do, lse, **kw)
    _, _, dv_ref = flash_attention_bwd_ref(q, k, v, do, **kw)
    want = (do[0, 5].float().reshape(Hkv, H // Hkv, Dh).sum(1)
            * torch.tensor(1.0 / S).to(torch.bfloat16).float())
    assert dq.eq(0).all() and dk.eq(0).all() and dv[1].eq(0).all()
    err, _, _, ok = bf16_agreement(torch, dv[0], want[None].expand(
        S, Hkv, Dh))
    assert ok and bf16_agreement(torch, dv, dv_ref)[3], err
    log("kernels.flash_bwd", call="keyless_row", shape=f"B={B},S={S},"
        f"H={H},Hkv={Hkv},Dh={Dh}", lse="NEG_INF", dq="0", dk="0",
        dv=f"dO/Skv on every key (max err {err:.3e})")
    return res


def kernels_scan_bwd(torch, lru_ops, linear_scan_ref, linear_scan_bwd_ref):
    """The scan's backward at the hybrid's training shape (4, 512, 2560):
    through the autograd Function (one launch of the backward kernel, one
    node in a CUDA graph captured from a call, and one kernel in the
    profiler's trace of a call where it reports device events) against
    autograd through ``linear_scan_ref`` in f32 and, bit for bit, against
    ``linear_scan_bwd_ref``; a control that reverses the adjoint without
    the shift of a by one must fail.  Returns its kernels entry."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    B, S, D = 4, 512, 2560
    a = torch.rand(B, S, D, generator=gen, device=dev) * 0.5 + 0.5
    b = torch.randn(B, S, D, generator=gen, device=dev)
    dh = torch.randn(B, S, D, generator=gen, device=dev)
    la, lb = a.clone().requires_grad_(), b.clone().requires_grad_()
    n_bwd = lru_ops.bwd_launches
    h = lru_ops.linear_scan(la, lb)
    h.backward(dh)
    assert lru_ops.bwd_launches == n_bwd + 1
    ra, rb = a.clone().requires_grad_(), b.clone().requires_grad_()
    linear_scan_ref(ra, rb).backward(dh)
    errs = {}
    for n, got, want in (("da", la.grad, ra.grad), ("db", lb.grad, rb.grad)):
        err, scale, ok = f32_agreement(torch, got, want, tol=1e-5)
        assert ok, (n, err, scale)
        errs[n] = f"max {err:.3e} of scale {scale:.3e}"
    da, db = linear_scan_bwd_ref(a, h.detach(), dh)
    assert torch.equal(la.grad, da) and torch.equal(lb.grad, db)
    # control: g_t = dh_t + a_t g_{t+1} (a not shifted)
    g_c = linear_scan_ref(a.flip(1), dh.flip(1)).flip(1)
    c_err, _, c_ok = f32_agreement(torch, g_c, rb.grad, tol=1e-5)
    assert not c_ok, "the check cannot see an unshifted adjoint"
    hd = h.detach()

    def run():
        return lru_ops.linear_scan_bwd(a, hd, dh)

    # one call is one kernel node of a captured graph and, where the
    # profiler reports device events, one kernel in its trace
    nodes = graph_nodes(torch, run)
    assert len(nodes) == 1 and "linear_scan_bwd_kernel" in nodes[0], nodes
    # control: the plain version's per-step passes are many nodes
    plain_nodes = len(graph_nodes(
        torch, lambda: linear_scan_bwd_ref(a, hd, dh)))
    assert plain_nodes > 1, "the graph's nodes cannot see a pass"
    _, device_ms, kernels_seen = profile_calls(torch, run, 20)
    assert not kernels_seen or (
        len(kernels_seen) == 1
        and "linear_scan_bwd_kernel" in kernels_seen[0][0]), kernels_seen
    b_ms, b_by = bound(5 * B * S * D * 4, 3 * B * S * D, "float32")
    entry = {
        "name": "linear_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/engine/models/rglru.py:57 (the associative "
                    "scan under jax.grad; no Pallas backward)",
        "launches": None, "max_abs_err": max(
            (la.grad - ra.grad).abs().max().item(),
            (lb.grad - rb.grad).abs().max().item()),
        "ms": time_ms(torch, run, iters=20), "device_ms": device_ms,
        "plain_ms": time_ms(torch, lambda: linear_scan_bwd_ref(a, hd, dh),
                            iters=2, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "library_note": "no single PyTorch call computes the reversed "
                        "recurrence"}
    log("kernels.scan_bwd", shape=f"B={B},S={S},D={D},f32",
        vs_autograd_through_plain=json.dumps(errs),
        vs_plain_bwd="bitwise", graph_nodes_a_call=len(nodes),
        control_plain_graph_nodes=plain_nodes,
        profiler_kernels_a_call=(json.dumps([k for k, _ in kernels_seen])
                                 if kernels_seen else "no device events"),
        control_unshifted_adjoint=
        f"max {c_err:.3e}: fails", ms=f"{entry['ms']:.4f}",
        device_ms=f"{entry['device_ms']:.4f}",
        plain_ms=f"{entry['plain_ms']:.4f}", bound_ms=f"{b_ms:.5f}",
        bound_by=b_by, library_ms="none")
    return entry


def worst_grad_gap(torch, grads, ref):
    """(the largest max|g - ref| / ||ref|| over the leaves, its leaf)."""
    worst = (0.0, None)
    for name, g in grads.items():
        r = ref[name].float()
        gap = (g.float() - r).abs().max().item() \
            / max(torch.linalg.vector_norm(r).item(), 1e-12)
        worst = max(worst, (gap, name))
    return worst


def train_counts(fa_ops, lru_ops):
    return {"flash": fa_ops.launches,
            "flash_tensor_core": fa_ops.tensor_core_launches,
            "flash_bwd": fa_ops.bwd_launches,
            "flash_bwd_tensor_core": fa_ops.bwd_tensor_core_launches,
            "scan": lru_ops.launches, "scan_bwd": lru_ops.bwd_launches}


def device_batch(torch, data, step, dev, **extra):
    out = {k: torch.from_numpy(v).to(dev)
           for k, v in data.batch_at(step).items()}
    out.update(extra)
    return out


def free_cuda(torch):
    gc.collect()
    torch.cuda.empty_cache()


def train_phases(torch, np, get_config, build_model, fa_ops, lru_ops,
                 plain_calls):
    """Training on the card through the port's entry points: full-width
    qwen3-1.7b through ``train_loop`` (bf16, B=8, S=512, remat, 20 steps),
    its launch counts per step and its profile; one step's gradients
    through the kernels against the plain versions (a float32 copy cut to
    4 layers, asserted; the full bf16 model, logged); a checkpoint at step
    10 resumed in a fresh ``train_loop`` against the continuous run; then
    recurrentgemma-2b (B=4, S=512, 3 steps) and whisper-tiny (B=8, 128
    tokens over 1500 frames, 3 steps).  Returns launch counts for the
    kernels line."""
    import statistics
    import tempfile

    from repro_torch.training import (AdamWConfig, DataConfig,
                                      SyntheticLMData, TrainerConfig,
                                      load_checkpoint, make_train_step,
                                      train_loop)
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.trainer import loss_and_grads

    dev = torch.device("cuda")
    out_counts = {}

    # ------------------------------------------------------- train.qwen3
    cfg = get_config("qwen3-1.7b")
    L = cfg.num_layers
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=512, global_batch=8)
    data = SyntheticLMData(dcfg)
    steps = 20
    tcfg = TrainerConfig(remat=True, adamw=AdamWConfig(
        lr=1e-3, warmup_steps=2, total_steps=steps))
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    fa_ops.reset_counts()
    lru_ops.reset_counts()
    plain0 = plain_calls["n"]
    t0 = time.perf_counter()
    out = train_loop(cfg, tcfg, dcfg, num_steps=steps, log_every=5, seed=0)
    run_s = time.perf_counter() - t0
    counts = train_counts(fa_ops, lru_ops)
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    gnorms = [h["grad_norm"] for h in hist]
    assert all(np.isfinite(losses)) and all(np.isfinite(gnorms)), hist
    assert losses[-1] < losses[0], losses
    assert plain_calls["n"] == plain0, "a plain version ran"
    assert counts["flash"] == counts["flash_tensor_core"] == 2 * L * steps \
        and counts["flash_bwd"] == counts["flash_bwd_tensor_core"] \
        == L * steps, counts
    step_ms = 1e3 * statistics.median(h["seconds"] for h in hist[1:])
    peak = torch.cuda.max_memory_allocated() / 2**30
    out_counts["flash_bwd"] = counts["flash_bwd"]
    out_counts["flash_train"] = counts["flash"]

    # one more step, split: the forward's launches, then the backward's
    model, opt = out["model"], out["opt_state"]
    params = dict(model.named_parameters())
    batch = device_batch(torch, data, steps, dev)
    fa_ops.reset_counts()
    loss = model.loss_fn(batch, remat=True)
    fwd = fa_ops.launches
    grads = torch.autograd.grad(loss, list(params.values()))
    split = {"forward": fwd, "recompute": fa_ops.launches - fwd,
             "backward": fa_ops.bwd_launches,
             "tensor_core": fa_ops.tensor_core_launches,
             "backward_tensor_core": fa_ops.bwd_tensor_core_launches}
    del grads, loss
    assert split == {"forward": L, "recompute": L, "backward": L,
                     "tensor_core": 2 * L, "backward_tensor_core": L}, split
    step_fn = make_train_step(model, tcfg)
    wall, busy, top = profile_calls(torch, lambda: step_fn(opt, batch), 1)
    out_counts["qwen3_step"] = {"wall_ms": wall, "busy_ms": busy,
                                "peak_gib": peak, "batch": 8, "seq": 512}
    log("train.qwen3", model=f"qwen3-1.7b(full width, {L} layers, "
        f"{cfg.param_count() / 1e9:.3f}B params)", dtype="bf16",
        batch="B=8,S=512", remat=True, steps=steps, lr=1e-3, warmup=2,
        loss_first=f"{losses[0]:.4f}", loss_last=f"{losses[-1]:.4f}",
        losses=json.dumps([round(x, 4) for x in losses]),
        grad_norms=json.dumps([round(x, 4) for x in gnorms]),
        step_ms_median_2_20=f"{step_ms:.3f}",
        tokens_per_s=f"{4096 / step_ms * 1e3:.1f}", run_s=f"{run_s:.3f}",
        max_memory_allocated_gib=f"{peak:.3f}",
        launches_per_step=json.dumps(split), launches=json.dumps(counts),
        plain_calls=plain_calls["n"] - plain0)
    log("train.qwen3.profile", call="one train step (B=8, S=512)",
        wall_ms=f"{wall:.3f}", device_busy_ms=f"{busy:.3f}",
        device_busy_share=f"{busy / wall:.3f}",
        top_kernels_ms=json.dumps(top))

    # the bf16 full-depth arm of the gradient parity, logged
    g_cuda = loss_and_grads(model, batch, remat=True, impl="cuda")[1]
    g_plain = loss_and_grads(model, batch, remat=True, impl="torch")[1]
    bf16_gap, bf16_leaf = worst_grad_gap(torch, g_cuda, g_plain)
    del g_cuda, g_plain, out, model, opt, params, step_fn, batch
    free_cuda(torch)

    # ------------------------------------------------- train.grad_parity
    cfg4 = cfg.replace(num_layers=4, dtype="float32", param_dtype="float32")
    m32 = build_model(cfg4, device=dev).init(
        torch.Generator(device=dev).manual_seed(1))
    m32.requires_grad_(True)
    batch = device_batch(torch, data, 0, dev)
    plain0 = plain_calls["n"]
    g_cuda = loss_and_grads(m32, batch, remat=True, impl="cuda")[1]
    assert plain_calls["n"] == plain0, "a plain version ran"
    g_plain = loss_and_grads(m32, batch, remat=True, impl="torch")[1]
    gap, leaf = worst_grad_gap(torch, g_cuda, g_plain)
    assert gap <= 1e-4, (gap, leaf)
    # control: the attention backward with its dK dropped
    orig = fa_ops.flash_attention_bwd

    def no_dk(*a, **kw):
        dq, dk, dv = orig(*a, **kw)
        return dq, torch.zeros_like(dk), dv

    fa_ops.flash_attention_bwd = no_dk
    try:
        g_ctrl = loss_and_grads(m32, batch, remat=True, impl="cuda")[1]
    finally:
        fa_ops.flash_attention_bwd = orig
    c_gap, c_leaf = worst_grad_gap(torch, g_ctrl, g_plain)
    assert c_gap > 1e-4, "the check cannot see a dropped dK"
    log("train.grad_parity", model="qwen3-1.7b float32 copy cut to 4 "
        "layers (full width)", batch="B=8,S=512", remat=True,
        worst_leaf=leaf, worst_max_abs_over_norm=f"{gap:.3e}",
        tolerance="1e-4 of each gradient's norm",
        control_dk_dropped=f"{c_leaf}: {c_gap:.3e}, fails",
        bf16_full_depth=f"{bf16_leaf}: {bf16_gap:.3e} (logged)")
    del m32, g_cuda, g_plain, g_ctrl
    free_cuda(torch)

    # -------------------------------------------------- train.checkpoint
    cfgc = cfg.replace(num_layers=4)
    tc = TrainerConfig(remat=True, adamw=AdamWConfig(
        lr=1e-3, warmup_steps=2, total_steps=12))
    kw = dict(seed=3, log_every=100)
    with tempfile.TemporaryDirectory() as d:
        cont = train_loop(cfgc, tc, dcfg, num_steps=12, **kw)
        cont_params = {n: p.detach().clone()
                       for n, p in cont["params"].items()}
        cont_hist = cont["history"]
        del cont
        free_cuda(torch)
        t0 = time.perf_counter()
        first = train_loop(cfgc, tc, dcfg, num_steps=10, ckpt_dir=d,
                           ckpt_every=10, **kw)
        init_save_s = time.perf_counter() - t0 - sum(
            h["seconds"] for h in first["history"])
        del first
        free_cuda(torch)
        resumed = train_loop(cfgc, tc, dcfg, num_steps=12, ckpt_dir=d, **kw)
        hist = resumed["history"]
        assert [h["step"] for h in hist] == [10, 11], hist
        rel = max(abs(h[k] - c[k]) / max(abs(c[k]), 1e-12)
                  for h, c in zip(hist, cont_hist[10:])
                  for k in ("loss", "grad_norm"))
        same = all(h[k] == c[k] for h, c in zip(hist, cont_hist[10:])
                   for k in ("loss", "grad_norm")) and all(
            torch.equal(p.detach(), cont_params[n])
            for n, p in resumed["params"].items())
        assert same or rel <= 1e-5, rel
        # control: the same checkpoint with its moments zeroed
        model = resumed["model"]
        params = dict(model.named_parameters())
        like = (params, adamw_init(params))
        del resumed
        _, loaded, opt, _ = load_checkpoint(
            str(pathlib.Path(d) / "step_000000010"), like)
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(loaded[n])
        opt["m"] = {n: torch.zeros_like(t) for n, t in opt["m"].items()}
        opt["v"] = {n: torch.zeros_like(t) for n, t in opt["v"].items()}
        step_fn = make_train_step(model, tc)
        ctrl = []
        for s in (10, 11):
            opt, met = step_fn(opt, device_batch(torch, data, s, dev))
            ctrl.append(float(met["loss"]))
        assert ctrl[1] != cont_hist[11]["loss"], \
            "the check cannot see lost optimizer moments"
        # the same state placed on a one-rank mesh
        distribution_checkpoint(
            torch, str(pathlib.Path(d) / "step_000000010"), cfgc, like)
        del model, params, like, loaded, opt, step_fn
    log("train.checkpoint", model="qwen3-1.7b bf16 cut to 4 layers (full "
        "width)", saved_at=10, resumed_steps="11-12",
        continuous=json.dumps([[h["loss"], h["grad_norm"]]
                               for h in cont_hist[10:]]),
        resumed=json.dumps([[h["loss"], h["grad_norm"]] for h in hist]),
        result="equal (losses, grad norms and every parameter bitwise)"
        if same else f"within {rel:.3e} relative (1e-5 allowed)",
        init_and_save_s=f"{init_save_s:.3f}", control_moments_zeroed=
        f"step 12 loss {ctrl[1]:.6f} vs {cont_hist[11]['loss']:.6f}: fails")
    del cont_params
    free_cuda(torch)

    # ------------------------------------------------------ train.hybrid
    cfg = get_config("recurrentgemma-2b")
    n_attn = sum(1 for i in range(cfg.num_layers)
                 if (cfg.block_pattern or ("rglru", "rglru", "attn"))[i % 3]
                 == "attn")
    n_rec = cfg.num_layers - n_attn
    n_left = cfg.num_layers % 3
    steps = 3
    dh = DataConfig(vocab_size=cfg.vocab_size, seq_len=512, global_batch=4)
    th = TrainerConfig(remat=True, adamw=AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=steps))
    torch.cuda.reset_peak_memory_stats()
    fa_ops.reset_counts()
    lru_ops.reset_counts()
    plain0 = plain_calls["n"]
    out = train_loop(cfg, th, dh, num_steps=steps, log_every=1, seed=0)
    counts = train_counts(fa_ops, lru_ops)
    hist = out["history"]
    assert all(np.isfinite([h["loss"] for h in hist])), hist
    assert plain_calls["n"] == plain0, "a plain version ran"
    # the groups are rematerialized (forward twice), the leftovers not
    want = {"flash": 2 * n_attn * steps, "flash_bwd": n_attn * steps,
            "scan": (2 * (n_rec - n_left) + n_left) * steps,
            "scan_bwd": n_rec * steps}
    assert all(counts[k] == n for k, n in want.items()), (counts, want)
    # Dh 256: forward and backward on the tensor cores
    assert counts["flash_tensor_core"] == counts["flash"] \
        and counts["flash_bwd_tensor_core"] == counts["flash_bwd"], counts
    out_counts["scan_bwd"] = counts["scan_bwd"]
    hybrid_ms = 1e3 * statistics.median(h["seconds"] for h in hist)
    step_fn = make_train_step(out["model"], th)
    batch = device_batch(torch, SyntheticLMData(dh), steps, dev)
    wall, busy, top = profile_calls(
        torch, lambda: step_fn(out["opt_state"], batch), 1)
    del step_fn, batch
    log("train.hybrid", model=f"recurrentgemma-2b(full width, "
        f"{cfg.num_layers} blocks: {n_attn} attention at Dh 256, {n_rec} "
        f"RG-LRU)", dtype="bf16", batch="B=4,S=512", steps=steps,
        losses=json.dumps([round(h["loss"], 4) for h in hist]),
        grad_norms=json.dumps([round(h["grad_norm"], 4) for h in hist]),
        step_ms=json.dumps([round(1e3 * h["seconds"], 3) for h in hist]),
        step_ms_median=f"{hybrid_ms:.3f}",
        max_memory_allocated_gib=
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
        launches=json.dumps(counts))
    log("train.hybrid.profile", call="one train step (B=4, S=512)",
        wall_ms=f"{wall:.3f}", device_busy_ms=f"{busy:.3f}",
        device_busy_share=f"{busy / wall:.3f}",
        top_kernels_ms=json.dumps(top))
    del out
    free_cuda(torch)

    # ------------------------------------------------------- train.audio
    cfg = get_config("whisper-tiny")
    model = build_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    model.requires_grad_(True)
    da = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                    global_batch=8))
    frames = torch.randn(8, cfg.enc_max_len, cfg.d_model, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(8))
    steps = 3
    ta = TrainerConfig(remat=True, adamw=AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=steps))
    step_fn = make_train_step(model, ta)
    opt = adamw_init(dict(model.named_parameters()))
    fa_ops.reset_counts()
    plain0 = plain_calls["n"]
    calls = {}
    orig = fa_ops.flash_attention_bwd

    def by_kind(q, k, *a, causal=True, **kw):
        kind = "causal" if causal else (
            "noncausal_self" if q.shape[1] == k.shape[1] else "cross")
        calls[kind] = calls.get(kind, 0) + 1
        return orig(q, k, *a, causal=causal, **kw)

    fa_ops.flash_attention_bwd = by_kind
    losses, step_s = [], []
    try:
        for s in range(steps):
            t0 = time.perf_counter()
            opt, met = step_fn(opt, device_batch(torch, da, s, dev,
                                                 frames=frames))
            losses.append(float(met["loss"]))
            step_s.append(time.perf_counter() - t0)
    finally:
        fa_ops.flash_attention_bwd = orig
    counts = train_counts(fa_ops, lru_ops)
    assert all(np.isfinite(losses)), losses
    assert plain_calls["n"] == plain0, "a plain version ran"
    E, Ld = cfg.enc_layers, cfg.num_layers
    assert calls == {"noncausal_self": E * steps, "causal": Ld * steps,
                     "cross": Ld * steps}, calls
    assert counts["flash"] == counts["flash_tensor_core"] \
        == 2 * (E + 2 * Ld) * steps and counts["flash_bwd"] \
        == counts["flash_bwd_tensor_core"] == (E + 2 * Ld) * steps, counts
    log("train.audio", model=f"whisper-tiny(full width, {E} + {Ld} layers, "
        f"d_model {cfg.d_model}, 6 heads of 64)", dtype="bf16",
        batch=f"B=8, 128 tokens, {cfg.enc_max_len} frames", steps=steps,
        losses=json.dumps([round(x, 4) for x in losses]),
        step_ms=json.dumps([round(1e3 * x, 3) for x in step_s]),
        flash_bwd_by_kind=json.dumps(calls), launches=json.dumps(counts))
    del model, opt, step_fn, frames
    free_cuda(torch)
    return out_counts


# ------------------------------------------------------------ distribution
# the sharded decode at deepseek-67b's attention width (64 query and 8 KV
# heads of 128), bf16, B=8 over T=32768 slots (1.07 GB of K and V), the
# context the JAX docstring motivates at one card's size; four ranks hold
# a quarter of T each
DIST_B, DIST_T, DIST_H, DIST_HKV, DIST_DH = 8, 32768, 64, 8, 128
DIST_WORLD = 4
DIST_WINDOWS = (0, 4096)
# each rank's gradients are one qwen3-1.7b layer's, at its own scale
DIST_GRAD_SCALES = (1.0, 30.0, 0.01, 300.0)


def dist_decode_inputs(torch, world=DIST_WORLD):
    """q, k, v (bf16) and positions on the card from a seeded generator,
    the same in every process.  Rows: 0 full; 1 full with every third slot
    empty; 2 and 3 whose valid keys end in the first shard (at 5000 and at
    its last slot); 4 whose 4096-key window crosses from the third shard
    into the fourth; 5 ending at the third shard's first slot; 6 (q
    position -1) and 7 (every slot empty) with no valid key anywhere."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(23)
    B, T, H, Hkv, Dh = DIST_B, DIST_T, DIST_H, DIST_HKV, DIST_DH
    S = T // world

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)

    q, k, v = randn(B, H, Dh), randn(B, T, Hkv, Dh), randn(B, T, Hkv, Dh)
    qp = torch.tensor([T - 1, T - 1, 5000, S - 1, 3 * S + 1000, 2 * S, -1,
                       T - 1], dtype=torch.int32, device=dev)
    kp = torch.arange(T, dtype=torch.int32, device=dev).repeat(B, 1)
    kp[1, ::3] = -1
    kp[7] = -1
    return q, k, v, qp, kp


def dist_rank_grads(torch, rank):
    """Rank ``rank``'s gradient dict: one full-width qwen3-1.7b layer's
    parameter shapes, f32, from its own seed and at its own scale."""
    from repro_torch.configs import get_config
    from repro_torch.engine.models import build_model
    sd = build_model(get_config("qwen3-1.7b"), device="meta").state_dict()
    g = torch.Generator(device="cuda").manual_seed(100 + rank)
    return {n: torch.randn(t.shape, generator=g, device="cuda")
            * DIST_GRAD_SCALES[rank]
            for n, t in sd.items() if n.startswith("blocks.0.")}


def dist_rank(rank, world, store, out_dir):
    """One of the ``[distribution.*]`` phase's ranks, in its own process
    sharing the one card: a gloo group whose collectives take the CUDA
    tensors (gloo copies them through the host: the transport these
    ranks use, chosen because NCCL takes one process per card).  The
    parent built the kernels and checks that this rank built none; it runs
    the sharded decode on its quarter of T (and once more with its keys
    dropped, the control), and the compressed all-reduce of its own
    gradients, and writes what it saw to ``out_dir/rank_<rank>.pt``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.distribution.collectives import (
        compressed_psum_grads, sharded_decode_attention)
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.training.grad_compress import (dequantize,
                                                    init_error_state,
                                                    quantize)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        _, plain_calls = card_setup(torch, np)
        res = {"built_here_s": build.build_seconds}
        q, k, v, qp, kp = dist_decode_inputs(torch, world)
        S = DIST_T // world
        k, v, kp = (x[:, rank * S:(rank + 1) * S].contiguous()
                    for x in (k, v, kp))
        torch.cuda.synchronize()
        da_ops.reset_counts()
        plain0 = plain_calls["n"]
        for w in DIST_WINDOWS:
            dist.barrier()
            t0 = time.perf_counter()
            out = sharded_decode_attention(q, k, v, qp, kp, window=w)
            torch.cuda.synchronize()
            res[f"call_ms_w{w}"] = 1e3 * (time.perf_counter() - t0)
            res[f"out_w{w}"] = out.cpu()
        res["launches"] = da_ops.launches
        res["split_launches"] = da_ops.split_launches
        res["plain_calls"] = plain_calls["n"] - plain0
        # control: this run with the last rank's keys dropped from the sums
        kp_drop = torch.full_like(kp, -1) if rank == world - 1 else kp
        res["dropped_w0"] = sharded_decode_attention(q, k, v, qp,
                                                     kp_drop).cpu()
        del k, v

        # compressed all-reduce: one qwen3-1.7b layer per rank
        every = [dist_rank_grads(torch, r) for r in range(world)]
        grads = every[rank]
        true = {n: sum(g[n] for g in every) / world for n in grads}
        step = {n: max(g[n].abs().max().item() for g in every) / 127.0
                for n in grads}
        del every
        dist.barrier()
        t0 = time.perf_counter()
        mean1, err1 = compressed_psum_grads(grads, init_error_state(grads))
        torch.cuda.synchronize()
        res["compressed_ms"] = 1e3 * (time.perf_counter() - t0)
        mean2, _ = compressed_psum_grads(grads, err1)
        res["mean_over_step"] = max(
            ((mean1[n] - true[n]).abs().max() / step[n]).item()
            for n in grads)
        # the JAX recipe: each rank's own scale, the sum dequantized by
        # the largest (ROADMAP Queue 3 item 12)
        recipe = 0.0
        for n, gr in grads.items():
            qn, s = quantize(gr)
            q32 = qn.to(torch.int32)
            dist.all_reduce(q32)
            s_max = s.clone()
            dist.all_reduce(s_max, op=dist.ReduceOp.MAX)
            got = dequantize(q32, s_max) / world
            recipe = max(recipe,
                         ((got - true[n]).abs().max() / s_max).item())
        res["recipe_over_largest_step"] = recipe

        def norm(d):
            return sum(float(x.double().pow(2).sum()) for x in d.values()
                       ) ** 0.5

        res["ef_two_steps"] = norm({n: mean1[n] + mean2[n] - 2 * true[n]
                                    for n in grads})
        res["no_ef_two_steps"] = norm({n: 2 * (mean1[n] - true[n])
                                       for n in grads})
        res["grad_elems"] = sum(x.numel() for x in grads.values())
        torch.save(res, pathlib.Path(out_dir) / f"rank_{rank}.pt")
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def one_rank_group(torch):
    """A world of one process on the card (NCCL), over a FileStore."""
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            str(pathlib.Path(tmp) / "store"), 1), rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def distribution_phases(torch, da_ops, decode_attention_ref, plain_calls):
    """``[distribution.sharded_decode]`` at world size 1 (an NCCL group of
    this process) and over four gloo ranks sharing the card, and
    ``[distribution.compressed]`` on those ranks.  Returns the decode
    kernel's launches and the phase's times for the kernels line."""
    from repro_torch.distribution.collectives import sharded_decode_attention
    from repro_torch.launch.mesh import make_debug_mesh
    t_phase = time.perf_counter()
    q, k, v, qp, kp = dist_decode_inputs(torch)
    pos = dict(q_positions=qp, kv_positions=kp)
    kernel = {w: da_ops.decode_attention(q, k, v, window=w, **pos)
              for w in DIST_WINDOWS}
    plain = {w: decode_attention_ref(q, k, v, window=w, **pos)
             for w in DIST_WINDOWS}
    for w in DIST_WINDOWS:
        ok = bf16_agreement(torch, kernel[w], plain[w])[3]
        assert ok and torch.all(kernel[w][6:] == 0), \
            f"unsharded kernel vs plain, window {w}"

    # world size 1: the merge of one part is out * l / l, which rounds
    # back to out's bf16 value, so it must equal the kernel bitwise
    with one_rank_group(torch):
        mesh = make_debug_mesh()
        group = mesh.get_group("model")
        da_ops.reset_counts()
        plain0 = plain_calls["n"]
        one = {w: sharded_decode_attention(q, k, v, qp, kp, group=group,
                                           window=w)
               for w in DIST_WINDOWS}
        torch.cuda.synchronize()
        w1_launches = da_ops.launches
        assert w1_launches == len(DIST_WINDOWS) and \
            plain_calls["n"] == plain0, (w1_launches, plain_calls["n"])
        for w in DIST_WINDOWS:
            assert torch.equal(one[w], kernel[w]), f"world 1, window {w}"
        w1_ms = time_ms(torch, lambda: sharded_decode_attention(
            q, k, v, qp, kp, group=group), iters=20)
        mesh_shape = tuple(mesh.shape)
    kernel_ms = time_ms(torch, lambda: da_ops.decode_attention(
        q, k, v, **pos), iters=20)
    # the same function as one PyTorch call, timed beside it
    import torch.nn.functional as F
    qs, kt, vt = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
    mask = ((kp >= 0) & (kp <= qp[:, None]))[:, None, None, :]
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, kt, vt, attn_mask=mask, enable_gqa=True), iters=20)
    valid = int(((kp >= 0) & (kp <= qp[:, None])).sum().item())
    nbytes = 2 * q.numel() * 2 + 2 * valid * DIST_HKV * DIST_DH * 2 \
        + 4 * (kp.numel() + DIST_B)
    b_ms, b_by = bound(nbytes, 4 * DIST_DH * DIST_H * valid, "bfloat16")
    log("distribution.sharded_decode", world=1, backend="nccl",
        mesh=json.dumps(mesh_shape),
        shape=f"B={DIST_B},T={DIST_T},H={DIST_H},Hkv={DIST_HKV},"
        f"Dh={DIST_DH},bf16", windows=json.dumps(DIST_WINDOWS),
        vs_unsharded_kernel="bitwise", launches=w1_launches, plain_calls=0,
        kernel_ms=f"{kernel_ms:.4f}", sharded_ms=f"{w1_ms:.4f}",
        library_ms=f"{library_ms:.4f}", bound_ms=f"{b_ms:.5f}",
        bound_by=b_by, valid_keys=valid)

    # four ranks, spawned once the kernels are built (card_setup), so no
    # rank runs nvcc
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ctx = mp.start_processes(dist_rank,
                                 args=(DIST_WORLD, f"{tmp}/store", tmp),
                                 nprocs=DIST_WORLD, join=False,
                                 start_method="spawn")
        while not ctx.join(timeout=1.0):
            if time.perf_counter() - t0 > 240:
                for p in ctx.processes:
                    p.kill()
                raise RuntimeError("distribution: the ranks took over 240 s")
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(pathlib.Path(tmp) / f"rank_{r}.pt")
                 for r in range(DIST_WORLD)]
    kern = {w: kernel[w].cpu() for w in DIST_WINDOWS}
    pl = {w: plain[w].cpu() for w in DIST_WINDOWS}
    worst = {}
    for r, res in enumerate(ranks):
        assert res["built_here_s"] == 0.0, f"rank {r} built the kernels"
        assert res["launches"] == len(DIST_WINDOWS) and \
            res["plain_calls"] == 0, (r, res["launches"], res["plain_calls"])
        for w in DIST_WINDOWS:
            out = res[f"out_w{w}"]
            assert torch.equal(out, ranks[0][f"out_w{w}"]), (r, w)
            assert torch.all(out[6:] == 0), f"no-key rows, rank {r}"
            for name, ref in (("kernel", kern[w]), ("plain", pl[w])):
                err, rms, ref_rms, ok = bf16_agreement(torch, out, ref)
                assert ok, (r, w, name, err, rms, ref_rms)
                worst[f"{name}_w{w}"] = max(worst.get(f"{name}_w{w}", 0.0),
                                            err)
    d_err, d_rms, d_ref, d_ok = bf16_agreement(
        torch, ranks[0]["dropped_w0"], kern[0])
    assert not d_ok, "the check cannot see a rank's keys dropped"
    log("distribution.sharded_decode", world=DIST_WORLD,
        transport="gloo with CUDA tensors (4 processes share the card)",
        rule=BF16_AGREEMENT, rows="full, full with holes, ends in shard 0 "
        "(x2), window across shards 2-3, ends at shard 2's first slot, no "
        "key (q position -1), no key (all slots empty)",
        max_abs_err=json.dumps({k: float(f"{e:.4e}")
                                for k, e in worst.items()}),
        no_key_rows="0", ranks_equal="bitwise",
        launches_per_rank=json.dumps([r["launches"] for r in ranks]),
        split_launches_per_rank=json.dumps(
            [r["split_launches"] for r in ranks]),
        plain_calls=0, rank_call_ms=json.dumps(
            [[round(r[f"call_ms_w{w}"], 3) for w in DIST_WINDOWS]
             for r in ranks]),
        spawn_s=f"{spawn_s:.3f}",
        control_last_rank_dropped=f"max_abs_err {d_err:.3e}, rms_err "
        f"{d_rms:.3e} of ref rms {d_ref:.3e}: fails")

    for r, res in enumerate(ranks):
        assert res["mean_over_step"] <= 1.0, (r, res["mean_over_step"])
        assert res["recipe_over_largest_step"] > 1.0, \
            (r, res["recipe_over_largest_step"])
        assert res["ef_two_steps"] < res["no_ef_two_steps"], r
    log("distribution.compressed", world=DIST_WORLD,
        grads="one qwen3-1.7b layer per rank (f32, "
        f"{ranks[0]['grad_elems']} values), scales "
        f"{json.dumps(DIST_GRAD_SCALES)}",
        mean_err_over_shared_step=f"{max(r['mean_over_step'] for r in ranks):.4f}",
        limit=1.0, two_steps_err_norm=f"{ranks[0]['ef_two_steps']:.4e}",
        without_feedback=f"{ranks[0]['no_ef_two_steps']:.4e}",
        compressed_ms=json.dumps([round(r["compressed_ms"], 3)
                                  for r in ranks]),
        control_jax_recipe=f"err {ranks[0]['recipe_over_largest_step']:.3f}"
        " steps of the largest scale: fails",
        phase_s=f"{time.perf_counter() - t_phase:.3f}")
    return {"launches": w1_launches + sum(r["launches"] for r in ranks),
            "world1_launches": w1_launches,
            "rank_launches": [r["launches"] for r in ranks],
            "kernel_ms": kernel_ms, "sharded_world1_ms": w1_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by}


def distribution_checkpoint(torch, ckpt_dir, cfg, like):
    """``[distribution.checkpoint]``: a checkpoint loaded with placements
    on a one-rank mesh (``param_shardings`` of ``cfg``) equals the plain
    load bitwise, every parameter and moment, local and whole."""
    from repro_torch.distribution import param_shardings
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.training import load_checkpoint
    plain = load_checkpoint(ckpt_dir, like)
    with one_rank_group(torch):
        mesh = make_debug_mesh()
        pls = param_shardings(like[0], mesh, cfg=cfg)
        placed = load_checkpoint(ckpt_dir, like, placements=pls, mesh=mesh)
        n = 0
        for a, b in ((placed[1], plain[1]), (placed[2]["m"], plain[2]["m"]),
                     (placed[2]["v"], plain[2]["v"])):
            for name, t in b.items():
                assert torch.equal(a[name].to_local(), t) and torch.equal(
                    a[name].full_tensor(), t), name
                n += 1
        assert placed[0] == plain[0] and torch.equal(placed[2]["step"],
                                                     plain[2]["step"])
        sharded = sum(any(p.is_shard() for p in pl) for pl in pls.values())
    log("distribution.checkpoint", world=1, backend="nccl",
        mesh=json.dumps(tuple(mesh.shape)), tensors=n,
        with_a_shard_placement=sharded,
        result="placed load == plain load, bitwise (local and whole)")


# ------------------------------------------------- dry run and roofline
# [dryrun.sweep]: the port's dry run (repro_torch.launch.dryrun: meta
# tensors over a fake process group, no card) over every arch and shape on
# the 16 x 16 mesh and on the 2 x 16 x 16 mesh, in one process for each of
# SWEEP_GROUPS ((archs, mesh flag): the groups balanced by the cells'
# trace seconds on the card's host), started after the last timed phase so
# that no timed phase shares the host's cores with it.  Every cell must
# report; the 2 x 16 x 16 cells still running SWEEP_BUDGET_S after the
# start are cut and counted.
SWEEP_GROUPS = ((("xlstm-350m",), "--single-pod"),
                (("xlstm-350m",), "--multi-pod"),
                (("deepseek-67b",), "--all"),
                (("mixtral-8x22b", "recurrentgemma-2b"), "--all"),
                (("qwen3-8b", "internvl2-2b"), "--all"),
                (("whisper-tiny", "llama3.2-3b"), "--all"),
                (("deepseek-moe-16b", "qwen3-1.7b"), "--all"))
SWEEP_BUDGET_S = 240.0
# the quick cells first, so that the 2 x 16 x 16 mesh gets through the most
SWEEP_SHAPES = ("decode_32k", "long_500k", "prefill_32k", "train_4k")
# [roofline.card]: counted FLOPs over model_flops (2 N a token for
# inference, 6 N for training, N the parameters, the tied embedding once)
# of three steps the script times, on the card's path (the flash and
# paged kernels counted by their own work), written from the arithmetic
# before the run.  qwen3-1.7b: N 1.7208e9, N_blocks 1.4097e9, the head
# D V = 3.112e8, 28 layers, 16 heads of 128.  Decode (B=8): 2 N a row,
# plus QK^T and PV over the keys the live rows attend, 2.29e5 FLOPs a key,
# at most 8 x 416 keys: 1.0 to 1.028.  Chunk prefill (S=384): 2 N_blocks
# a token, the head for one token and the causal triangle (384 x 385 / 2
# pairs): 0.8325.  Remat train step (B=8, S=512): the blocks' forward
# twice and their backward (8 N_blocks a token), the head's forward and
# backward (6 D V), flash forward twice and backward (18 Dh H a pair):
# 1.299, less the last op of each block that torch's non-reentrant
# checkpoint does not recompute (-0.068): 1.231.
ROOFLINE_BANDS = {"decode": (1.0, 1.03), "prefill": (0.80, 0.86),
                  "train": (1.15, 1.30)}


class DryrunSweep:
    """The [dryrun.sweep] processes, their output files and the cells
    they report."""

    def __init__(self, out_dir: pathlib.Path):
        import os
        self.out = out_dir
        self.t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   OMP_NUM_THREADS="1")
        self.logs, self.procs = [], []
        for i, (archs, meshes) in enumerate(SWEEP_GROUPS):
            log_path = out_dir / f"sweep_{i}.log"
            self.logs.append(log_path)
            with open(log_path, "w") as f:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     meshes, "--arch", ",".join(archs), "--shape",
                     ",".join(SWEEP_SHAPES), "--out", str(out_dir / "cells")],
                    cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT))

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def cells(self) -> dict:
        """{(arch, shape, mesh): status} of the cells reported so far."""
        out = {}
        for log_path in self.logs:
            for line in log_path.read_text().splitlines():
                m = re.match(r"\[(ok|error|skipped)\s*\] (\S+)\s+(\S+)\s+"
                             r"(\S+)", line)
                if m:
                    out[m.group(2), m.group(3), m.group(4)] = m.group(1)
        return out

    def finish(self, deadline_s: float) -> dict:
        """Wait until every process ends or, past ``deadline_s`` on the
        sweep's clock, until every 16 x 16 cell has reported; then end
        what still runs.  Returns the cells and the sweep's seconds."""
        from repro_torch.configs import ARCH_IDS, SHAPES
        single = {(a, s, "pod16x16") for a in ARCH_IDS for s in SHAPES}
        while any(p.poll() is None for p in self.procs):
            done = single <= set(self.cells())
            if done and time.perf_counter() - self.t0 > deadline_s:
                break
            time.sleep(1.0)
        cut = 0
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                cut += 1
            p.wait()
        return self.cells(), time.perf_counter() - self.t0, cut


def dryrun_sweep_phase(sweep: DryrunSweep, deadline_s: float):
    """[dryrun.sweep]: no error in any reported cell; every 16 x 16 cell
    reported; the skipped cells are the full-attention archs at long_500k
    (JAX's ``shape_applicable`` set), on each mesh; each ok cell's
    roofline row printed."""
    from repro_torch.configs import ARCH_IDS, SHAPES, all_configs
    from repro_torch.launch.roofline import analyze_cell, load_cells
    cells, secs, cut = sweep.finish(deadline_s)
    errors = sorted(k for k, v in cells.items() if v == "error")
    for log_path in sweep.logs:
        if errors:
            print(log_path.read_text()[-3000:], file=sys.stderr)
    assert not errors, errors
    full_attn = {a for a, c in all_configs().items() if c.full_attention}
    assert full_attn == {"deepseek-moe-16b", "whisper-tiny", "deepseek-67b",
                         "llama3.2-3b", "qwen3-1.7b", "qwen3-8b",
                         "internvl2-2b"}, full_attn
    by_mesh = {}
    for mesh in ("pod16x16", "pod2x16x16"):
        mine = {(a, s): v for (a, s, m), v in cells.items() if m == mesh}
        skipped = {k for k, v in mine.items() if v == "skipped"}
        assert skipped == {(a, "long_500k") for a in full_attn
                           if (a, "long_500k") in mine}, (mesh, skipped)
        by_mesh[mesh] = {"ok": sum(v == "ok" for v in mine.values()),
                         "skipped": len(skipped),
                         "of": len(ARCH_IDS) * len(SHAPES)}
    assert by_mesh["pod16x16"] == {"ok": 33, "skipped": 7, "of": 40}, by_mesh
    for mesh in ("pod16x16", "pod2x16x16"):
        for cell in load_cells(str(sweep.out / "cells"), mesh):
            r = analyze_cell(cell)
            log("dryrun.roofline", arch=r["arch"], shape=r["shape"],
                mesh=mesh, compute_s=f"{r['t_compute_s']:.6g}",
                memory_s=f"{r['t_memory_s']:.6g}",
                collective_s=f"{r['t_collective_s']:.6g}",
                dominant=r["dominant"],
                useful_flop_ratio=f"{r['useful_flop_ratio']:.4f}",
                roofline_pct=f"{100 * r['roofline_fraction']:.3f}",
                hbm_fit=r["hbm_fit"], trace_s=cell["trace_s"])
    log("dryrun.sweep", processes=len(SWEEP_GROUPS), errors=0,
        pod16x16=json.dumps(by_mesh["pod16x16"]),
        pod2x16x16=json.dumps(by_mesh["pod2x16x16"]),
        cut_processes=cut, sweep_s=f"{secs:.3f}",
        budget=f"{SWEEP_BUDGET_S:.0f} s, after the card's phases",
        device="none (meta tensors, fake group)")
    return by_mesh


PAGED_TABLE_PROMPTS = ("cold_c", "share_a", "share_b", "cold_d")
PAGED_TABLE_NEW = 8
PAGED_TABLE_SLACK = 1.25    # a winner re-timed slower than this x the best


@contextlib.contextmanager
def forced_variant(pd_ops, variant, pages_per_block):
    """Inside the block the paged kernel's table is one whose default
    names ``variant`` at ``pages_per_block``: the way to force a model's
    decode step, which reads the table, to a variant."""
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "paged_table.json"
        path.write_text(json.dumps({"configs": {"default": {
            "variant": variant, "pages_per_block": pages_per_block}}}))
        checked_in, pd_ops._DEFAULT_TABLE = pd_ops._DEFAULT_TABLE, str(path)
        try:
            yield
        finally:
            pd_ops._DEFAULT_TABLE = checked_in


def paged_table_phase(torch, eng, prompts, pd_ops, smi, InferenceEngine):
    """[kernels.paged_table]: the paged kernel's checked-in table
    (``autotune.json``, the sweep's output, ``tune.py``), read as
    ``kernel_config`` reads it (``pd_ops.table()``): its provenance and
    whether it was swept on this card at this power limit (printed: a
    stale table is slower, not wrong); at each key the winner, the
    built-in default (``fused`` at ``DEFAULT_PAGES_PER_BLOCK``) and every
    distinct candidate of the sweep (``tune.candidates``) re-timed under
    the sweep's method, the winner no more than ``PAGED_TABLE_SLACK``
    times the best of them at its own key; then a qwen3 engine on
    ``eng``'s weights under the checked-in table must launch, counted
    from 0, the table's variant and nothing else, and give the greedy
    tokens of an engine on the same weights under a table forced to
    another variant (``forced_variant``: ``single``, or ``fused`` where
    the table names ``single``): the variants are bitwise equal.  Each
    engine is freed before the next."""
    from repro_torch.kernels.paged_decode_attention import tune
    t0 = time.perf_counter()
    table = pd_ops.table()
    prov = table["_provenance"]
    log("kernels.paged_table", table="src/repro_torch/kernels/"
        "paged_decode_attention/autotune.json",
        swept_on=json.dumps(prov["card"]), this_card=json.dumps(smi),
        same_card_and_limit=prov["card"] == smi, date=prov["date"],
        torch=prov["torch"], cuda=prov["cuda"],
        command=json.dumps(prov["command"]))
    default = {"variant": pd_ops.DEFAULT_VARIANT,
               "pages_per_block": pd_ops.DEFAULT_PAGES_PER_BLOCK}
    for key, shape in tune.paged_shapes().items():
        ps, dh = shape["page_size"], shape["head_dim"]
        win = pd_ops.kernel_config(ps, shape["kv_heads"], dh, shape["group"])
        cands = [tune.candidate(c["variant"], c["pages_per_block"], ps, dh,
                                name)
                 for name, c in (("winner", win), ("default", default))]
        cands += tune.candidates(ps, dh)
        timed = tune.time_key(shape, cands)
        score = {k: r["score_ms"] for k, r in timed.items()}
        best = min(score, key=score.get)
        over_best = score["winner"] / score[best]
        log("kernels.paged_table", key=key, archs=",".join(shape["archs"]),
            winner=tune.label(win["variant"], win["pages_per_block"]),
            winner_stage=cands[0]["stage"],
            default=tune.label(default["variant"],
                               default["pages_per_block"]),
            default_stage=cands[1]["stage"],
            winner_ms=json.dumps({g: round(ms, 4) for g, ms in
                                  timed["winner"]["ms"].items()}),
            score_ms=json.dumps({k: round(v, 4) for k, v in score.items()}),
            best=best, winner_over_best=f"{over_best:.4f}",
            winner_over_default=f"{score['winner'] / score['default']:.4f}",
            swept_score_ms=json.dumps({
                k: round(r["score_ms"], 4)
                for k, r in table["sweep"].get(key, {}).items()}))
        assert over_best <= PAGED_TABLE_SLACK, (key, best, over_best)
    want = table_config(pd_ops, eng)
    other = "fused" if want["variant"] == "single" else "single"
    toks = [prompts[n] for n in PAGED_TABLE_PROMPTS]
    runs = {}
    for arm in (None, other):
        with (forced_variant(pd_ops, arm, want["pages_per_block"]) if arm
              else contextlib.nullcontext()):
            e = InferenceEngine(eng.cfg, seed=0)
            e.load(eng.model.state_dict())
            pd_ops.reset_counts()

            def serve():
                out = e.generate(toks, max_new_tokens=PAGED_TABLE_NEW)
                e.drain()
                return out

            out, ran = device_kernels(torch, serve)
            runs[arm] = (out, dict(pd_ops.variant_launches))
            assert kernels_named(ran, PAGED_KERNEL) == pd_ops.launches, \
                (arm, kernels_named(ran, PAGED_KERNEL), pd_ops.launches)
            free_engine(torch, e)
    (table_out, table_n), (other_out, other_n) = runs[None], runs[other]
    assert sum(table_n.values()) > 0 \
        and table_n[want["variant"]] == sum(table_n.values()), \
        (want, table_n)
    assert other_n[other] == sum(other_n.values()) > 0, other_n
    assert table_out == other_out, \
        f"the table's variant and {other} gave different tokens"
    log("kernels.paged_table", engine="qwen3-1.7b(full width)",
        requests=len(toks), tokens_each=PAGED_TABLE_NEW,
        table_config=json.dumps(want),
        variant_launches=json.dumps(table_n), other_arm=other,
        other_arm_variant_launches=json.dumps(other_n),
        tokens_equal_other_arm=True, s=f"{time.perf_counter() - t0:.3f}")
    return {"config": want, "variant_launches": table_n}


def count_steps(torch, cfg, dec, pf, tr):
    """``op_cost``'s counts of three of ``cfg``'s steps on meta with no
    mesh, as the card runs them (``attention_impl="cuda"``: each hand
    kernel charges its own work, ``cost_hooks.charge``): the paged decode
    step over a (B, pages) table of ``dec`` = (B, pages, page size, pool
    dtype), every slot the table names charged, the chunk prefill of S
    tokens into a (1, T) view (``pf``), and the remat train step on (B,
    S) tokens (``tr``).  Needs no card.  Returns the counts and the
    paged layout (layers, KV heads, Dh).  The decode step takes the
    variant the paged kernel's table names: the one the card's engine
    launches."""
    from repro_torch.engine.models import build_model
    from repro_torch.launch.op_cost import analyze_ops
    from repro_torch.training import AdamWConfig, TrainerConfig
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.trainer import make_train_step

    def meta(*shape, dtype=torch.int32):
        return torch.empty(*shape, dtype=dtype, device="meta")

    model = build_model(cfg.replace(attention_impl="cuda"), device="meta")
    layout = model.paged_kv_layout()
    B, n_pages, ps, pool_dtype = dec
    pools = [meta(layout[0], B * n_pages, ps, *layout[1:], dtype=pool_dtype)
             for _ in range(2)]
    out = {"decode": analyze_ops(model.paged_decode_step, meta(B), *pools,
                                 meta(B, n_pages), meta(B))}
    out["prefill"] = analyze_ops(
        model.prefill_with_cache, meta(1, pf[0]),
        model.init_cache(1, pf[1]), valid_len=meta(1))
    model.requires_grad_(True)
    opt = adamw_init(dict(model.named_parameters()))
    step = make_train_step(model, TrainerConfig(remat=True, adamw=AdamWConfig(
        lr=1e-3, warmup_steps=2, total_steps=20)))
    out["train"] = analyze_ops(
        step, opt, {"tokens": meta(*tr), "labels": meta(*tr)})
    return out, layout


def roofline_card_phase(torch, get_config, engine_profile, engine_shapes,
                        train_step):
    """[roofline.card]: qwen3-1.7b's paged decode step (B=8) and chunk
    prefill (``[engine.profile]``) and ``[train.qwen3]``'s step, each
    counted by ``op_cost`` at its shapes as the card runs it, the hand
    kernels by their own traffic: bound = max(FLOPs / 989 TFLOP/s, bytes
    / 3.35 TB/s) must not pass the measured device-busy time, and the
    FLOPs must fall in ``ROOFLINE_BANDS`` of ``model_flops``.  The
    decode's count is made exact for this step's lengths: the paged
    kernel charged on meta every slot its table names, and the slots past
    each row's pages (K and V) and past its length (QK^T and PV) come
    off.  Beside the train step, ``per_device_bytes`` of the dry run's
    arithmetic on a one-device mesh and the card's peak (logged)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.configs.base import HBM_BW, PEAK_FLOPS_BF16
    from repro_torch.kernels.paged_decode_attention import ops as pd_ops
    from repro_torch.launch.dryrun import _activation_residency
    cfg = get_config("qwen3-1.7b")
    measured = {("decode" if what.startswith("decode") else "prefill"):
                (busy, wall) for what, (wall, busy, _) in
                engine_profile.items()}
    B, n_pages, ps, pool_dtype, lens = engine_shapes["decode"]
    S_pf, T_pf = engine_shapes["prefill"]
    B_tr, S_tr = train_step["batch"], train_step["seq"]
    measured["train"] = (train_step["busy_ms"], train_step["wall_ms"])
    shapes = {"decode": {"B": B, "T": n_pages * ps, "lengths": lens},
              "prefill": {"S": S_pf, "T": T_pf},
              "train": {"B": B_tr, "S": S_tr}}
    counts, (n_layers, Hkv, Dh) = count_steps(
        torch, cfg, (B, n_pages, ps, pool_dtype), (S_pf, T_pf), (B_tr, S_tr))
    live = [n for n in lens if n >= 0]
    named = B * n_pages * ps
    held = sum(-(-(n + 1) // ps) * ps for n in live)
    valid = sum(n + 1 for n in live)
    elem = torch.empty((), dtype=pool_dtype).element_size()
    counts["decode"]["bytes"] -= n_layers * 2 * Hkv * Dh * elem * (
        named - held)
    counts["decode"]["flops"] -= n_layers * 4 * cfg.num_heads * Dh * (
        named - valid)
    shapes["decode"].update(slots_named=named, slots_held=held,
                            keys_attended=valid)
    kc = pd_ops.kernel_config(ps, Hkv, Dh, cfg.num_heads // Hkv)
    paged_variant = f"{kc['variant']}@{kc['pages_per_block']}"
    n = cfg.active_param_count()
    tokens = {"decode": B, "prefill": S_pf, "train": B_tr * S_tr}
    shares = {}
    for kind, r in counts.items():
        busy, wall = measured[kind]
        mf = (6.0 if kind == "train" else 2.0) * n * tokens[kind]
        ratio = r["flops"] / mf
        lo, hi = ROOFLINE_BANDS[kind]
        t_ops, t_bytes = r["flops"] / PEAK_FLOPS_BF16, r["bytes"] / HBM_BW
        bound_ms = 1e3 * max(t_ops, t_bytes)
        assert lo <= ratio <= hi, (kind, ratio, ROOFLINE_BANDS[kind])
        assert bound_ms <= busy, (kind, bound_ms, busy)
        shares[kind] = bound_ms / busy
        log("roofline.card", step=kind, model="qwen3-1.7b(full width)",
            path="cuda (hand kernels)", shape=json.dumps(shapes[kind]),
            counted_flops=f"{r['flops']:.6g}", model_flops=f"{mf:.6g}",
            flops_over_model=f"{ratio:.4f}", band=json.dumps([lo, hi]),
            bytes=f"{r['bytes']:.6g}", bound_ms=f"{bound_ms:.4f}",
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            device_busy_ms=f"{busy:.4f}", wall_ms=f"{wall:.4f}",
            share_bound_over_busy=f"{bound_ms / busy:.4f}",
            peaks=PEAKS_OF,
            **({"paged_variant": paged_variant} if kind == "decode" else {}))
    model_bytes = 2 * cfg.param_count()          # bf16 weights
    args = model_bytes + 2 * 4 * cfg.param_count() + 2 * 4 * B_tr * S_tr
    est = args + _activation_residency(
        cfg, ShapeSpec("train", S_tr, B_tr, "train"),
        type("Mesh", (), {"shape": {"data": 1, "model": 1}})())
    log("roofline.card.memory", step="train", mesh="1 x 1",
        per_device_bytes_gib=f"{est / 2**30:.3f}",
        max_memory_allocated_gib=f"{train_step['peak_gib']:.3f}",
        asserted=False)
    return shares


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.configs.deepseek_v2 import CONFIG as dsv2
    from repro_torch.engine import tokenizer
    from repro_torch.engine.engine import InferenceEngine
    from repro_torch.engine.models import build_model, layers, moe
    from repro_torch.engine.models.mla import softmax_scale
    from repro_torch.kernels import build
    from repro_torch.kernels.common import NEG_INF
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, lse_combine)
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_lse_ref, flash_attention_ref)
    from repro_torch.kernels.latent_decode_attention import ops as ld_ops
    from repro_torch.kernels.latent_decode_attention.ref import (
        latent_decode_attention_ref)
    from repro_torch.kernels.paged_decode_attention import ops as pd_ops
    from repro_torch.kernels.paged_decode_attention.ref import (
        paged_decode_attention_ref, scatter_append_ref)
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.kernels.rglru_scan.ref import (linear_scan_bwd_ref,
                                                   linear_scan_ref)
    from repro_torch.kernels.shared_prefix_attention import ops as sp_ops
    from repro_torch.kernels.shared_prefix_attention.ref import (
        prefix_attention_ref, shared_prefix_attention_ref)

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    clock = PhaseClock(t_start)

    # ------------------------------------------------------ 1. environment
    t0 = time.perf_counter()
    t, plain_calls = card_setup(torch, np)
    log("env", card=json.dumps(smi), torch=torch.__version__,
        cuda=torch.version.cuda, build_s=f"{build.build_seconds:.3f}",
        load_s=f"{time.perf_counter() - t0:.3f}")
    clock.lap("env")

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

    # flash and the paged kernel at the served models' head groupings
    at = {arch: kernels_at_grouping(torch, F, rng, arch, H, Hkv)
          for arch, H, Hkv in GROUPINGS}
    main_arch = GROUPINGS[0][0]
    log("kernels.paged_groups", Dh=128, pool="f32", q="bf16",
        checks="single vs plain, blocked==single bitwise, fused=="
        "scatter-then-attend bitwise, row alone vs in a batch of 8 "
        "bitwise, padding row pinned", tolerance=3e-2,
        **{f"{kind}_{a.replace('-', '_').replace('.', '_')}":
           json.dumps(fmt(r[kind])) for a, r in at.items()
           if a != main_arch for kind in ("paged", "flash")})

    main_at = at.pop(main_arch)
    csrc, tpu = "src/repro_torch/kernels/csrc", "src/repro/kernels"
    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": f"{csrc}/flash_attention.cu",
         "replaces": f"{tpu}/flash_attention/kernel.py:76",
         "launches": None, **main_at["flash"],
         "groups": {a: r["flash"] for a, r in at.items()}},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": f"{csrc}/paged_decode_attention.cu",
         "replaces": f"{tpu}/paged_decode_attention/kernel.py:375",
         "launches": None, **main_at["paged"],
         "groups": {a: r["paged"] for a, r in at.items()}}]
    # the attend-only arms replace the JAX package's single- and
    # several-page kernels: entries of their own, appended last
    arm_entries = [
        {"name": f"paged_decode_attention_{variant}", "route": "cuda",
         "source": f"{csrc}/paged_decode_attention.cu",
         "replaces": f"{tpu}/paged_decode_attention/kernel.py:{line}",
         "launches": None, **main_at["arms"][variant],
         "groups": {a: r["arms"][variant] for a, r in at.items()}}
        for variant, line in (("single", 106), ("blocked", 317))]
    del at, main_at

    kernels.append(kernels_decode(torch, F, t, rng, da_ops,
                                  decode_attention_ref, lse_combine, NEG_INF))
    kernels.append(kernels_scan(torch, rng, lru_ops, linear_scan_ref))
    kernels[0]["dh256"] = kernels_flash_hybrid(torch, F, t, rng, fa_ops,
                                               flash_attention_ref)
    kernels_shared_prefix(torch, t, rng, sp_ops, prefix_attention_ref,
                          shared_prefix_attention_ref, NEG_INF)
    kernels[0]["noncausal"] = kernels_flash_noncausal(
        torch, F, t, rng, fa_ops, flash_attention_ref)
    kernels[2]["cross"] = kernels_decode_cross(
        torch, F, t, rng, da_ops, decode_attention_ref, layers)
    swa = kernels_swa(torch, F, t, rng, fa_ops, da_ops, flash_attention_ref,
                      decode_attention_ref)
    kernels[0]["mixtral_prefill"] = swa["prefill"]
    kernels[2]["mixtral_ring"] = swa["ring"]
    torch.cuda.empty_cache()
    clock.lap("kernels")

    # ----------------------------------------------------- 3. shared prefix
    kernels.append(shared_prefix_full(torch, F, np, sp_ops, da_ops, pd_ops,
                                      prefix_attention_ref,
                                      shared_prefix_attention_ref))
    clock.lap("kernels.shared_prefix.full")

    # ----------------------------------------------------------- 4. engine
    cfg = get_config("qwen3-1.7b")
    eng = InferenceEngine(cfg, seed=0)
    torch.cuda.reset_peak_memory_stats()
    load_s = eng.load()
    prompts, n_shared = family_prompts(np, tokenizer, cfg.vocab_size, 3,
                                       dict(ENGINE_PROMPTS))
    assert all(100 <= len(p) <= 400 for p in prompts.values())
    assert n_shared % eng.page_size != 0
    max_new = 32

    # the plain versions are counted (card_setup): none may run on the
    # CUDA path
    outs, launches, step_s, admit_s, run_s = serve_checked(
        torch, eng, prompts, max_new, ENGINE_REQUESTS, fa_ops, pd_ops,
        plain_calls)
    fa_launches = launches["flash_attention"]
    pd_launches = launches["paged_decode_attention"]
    pd_split = launches["paged_split"]
    kernels[0]["launches"] = fa_launches
    kernels[0]["tensor_core_launches"] = launches["flash_tensor_core"]
    kernels[1]["launches"] = pd_launches
    kernels[1]["split_launches"] = pd_split
    st = eng.stats
    assert outs["cold_c_dup"] == outs["cold_c"]
    assert st.prefix_hits >= 1 and st.coalesced_requests >= 1 \
        and st.peak_batch >= 2, st.as_dict()
    n_steps = len(step_s)
    calls = len(admit_s)
    log("engine.run", model="qwen3-1.7b(full width, 28 layers)",
        requests=len(outs), prefill_calls=calls,
        prefill_rows=st.prefill_rows, tokens_each=max_new,
        prefix_hits=st.prefix_hits, tokens_reused=st.tokens_reused,
        coalesced=st.coalesced_requests, peak_batch=st.peak_batch,
        admission_waves=st.admission_waves, decode_steps=n_steps,
        decode_tokens=st.decode_tokens, load_s=f"{load_s:.3f}",
        run_s=f"{run_s:.3f}")
    decode_s = sum(step_s)
    log("engine.perf", decode_tok_per_s=f"{st.decode_tokens / decode_s:.2f}",
        mean_step_ms=f"{1e3 * decode_s / n_steps:.3f}",
        prefill_ms_per_call=f"{1e3 * sum(admit_s) / calls:.3f}",
        flash_launches=fa_launches,
        flash_tensor_core_launches=launches["flash_tensor_core"],
        flash_launches_per_call=f"{fa_launches / calls:.1f}",
        paged_launches=pd_launches, paged_split_launches=pd_split,
        paged_launches_per_step=f"{pd_launches / n_steps:.1f}",
        max_memory_allocated_gib=
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
        plain_calls=launches["plain_calls"])

    # one decode step under impl="cuda" and under impl="torch" over
    # copies of the same pool: bf16 activations through 28 layers, the
    # plain path rounding probs to bf16 before PV
    diff, scale, same_argmax = step_parity(torch, np, eng)[:3]
    assert diff <= 5e-2 * scale, (diff, scale)
    log("engine.step_parity", rows=4, max_abs_diff=f"{diff:.4e}",
        logit_scale=f"{scale:.4e}", tolerance="5e-2*scale",
        same_argmax=same_argmax)
    # the same step on a float32 copy of the weights: what is left of the
    # difference past f32 rounding is a fault, not bf16 rounding
    m32 = f32_copy(torch, build_model, eng)
    diff, scale, same_argmax = step_parity(torch, np, eng, model=m32)[:3]
    del m32
    assert diff <= 1e-3 * scale, (diff, scale)
    log("engine.step_parity", dtype="float32", rows=4,
        max_abs_diff=f"{diff:.4e}", logit_scale=f"{scale:.4e}",
        tolerance="1e-3*scale", same_argmax=same_argmax)

    # where a step's time goes: the profiler's device kernels over a few
    # decode steps (the 5 warm rows padded to 8, as the engine pads) and
    # over one 384-token cold chunk prefill
    engine_shapes = {}
    engine_profile = profile_engine(torch, np, eng, prompts["cold_c"],
                                    max_new, engine_shapes)
    for what, (wall_ms, busy_ms, top) in engine_profile.items():
        log("engine.profile", call=what,
            wall_ms_per_call=f"{wall_ms:.3f}",
            device_busy_ms_per_call=f"{busy_ms:.3f}",
            device_busy_share=f"{busy_ms / wall_ms:.3f}",
            top_kernels_ms_per_call=json.dumps(top))

    # the decode step's graphs against the eager step, one request (the
    # engine's warm rows are released)
    engine_decode_graphs(torch, eng, prompts["cold_c"], max_new)

    # batch invariance: the request decoded first in a batch of up to six
    # rows, decoded again alone (cold prefill, batch of one); on the
    # float32 copy the attention kernels' bits do not depend on the batch,
    # but cuBLAS may pick its GEMM by the batch's row count, so the result
    # is logged, not asserted
    e32, _ = batch_invariance(torch, InferenceEngine, eng, "engine", prompts,
                              outs, "cold_c", max_new, ENGINE_REQUESTS,
                              asserted=False)
    free_engine(torch, e32)

    engine_dense_view(torch, np, eng, prompts, outs, max_new, da_ops,
                      pd_ops, InferenceEngine)
    clock.lap("engine")
    # the paged kernel's per-shape table: re-timed, and followed by the
    # engine's decode
    kernels[1]["table"] = paged_table_phase(torch, eng, prompts, pd_ops, smi,
                                            InferenceEngine)
    clock.lap("kernels.paged_table")
    # free qwen3's weights and pool before the hybrid loads
    free_engine(torch, eng)
    del eng

    # ----------------------------------------------------------- 5. hybrid
    hyb = hybrid_phases(torch, np, get_config, tokenizer, InferenceEngine,
                        fa_ops, da_ops, lru_ops, pd_ops, plain_calls)
    kernels[2]["launches"] = hyb["decode_attention"]
    kernels[2]["split_launches"] = hyb["decode_split"]
    kernels[3]["launches"] = hyb["rglru_scan"]
    gc.collect()
    torch.cuda.empty_cache()
    clock.lap("hybrid")

    # -------------------------------------------------------- 6. processor
    proc = processor_phases(torch, fa_ops, pd_ops, da_ops, sp_ops, lru_ops,
                            plain_calls)
    kernels[0]["processor_launches"] = proc["flash_attention"]
    kernels[0]["processor_tensor_core_launches"] = proc["flash_tensor_core"]
    kernels[1]["processor_launches"] = proc["paged_decode_attention"]
    kernels[1]["processor_split_launches"] = proc["paged_split"]

    gc.collect()
    torch.cuda.empty_cache()
    clock.lap("processor")

    # ------------------------------------------------------ 7. the MoE family
    runs = {"moe": moe_phases(torch, np, get_config, tokenizer,
                              InferenceEngine, moe, fa_ops, pd_ops,
                              plain_calls)}
    clock.lap("moe")
    # --------------------------------------------- 8. the rest of the dense
    # family, deepseek-67b cut to 40 of its 95 layers (58.7 GB in bf16)
    for arch, key, depth in (("qwen3-8b", "qwen3_8b", None),
                             ("llama3.2-3b", "llama3_2_3b", None),
                             ("deepseek-67b", "deepseek_67b", 40)):
        runs[key] = dense_family_phase(
            torch, np, arch, get_config, tokenizer, InferenceEngine, fa_ops,
            pd_ops, da_ops, plain_calls, layers=depth)
    clock.lap("dense")
    families = (torch, np, get_config, tokenizer, InferenceEngine,
                build_model, fa_ops, pd_ops, da_ops, plain_calls)
    # ------------------------------ 9. sliding-window attention: mixtral
    mixtral = swa_phases(*families)
    kernels[0]["mixtral_launches"] = mixtral["flash_attention"]
    kernels[0]["mixtral_tensor_core_launches"] = \
        mixtral["flash_tensor_core"]
    kernels[2]["mixtral_launches"] = mixtral["decode_attention"]
    kernels[2]["mixtral_split_launches"] = mixtral["decode_split"]
    clock.lap("swa")
    # ------------------------ 10. the VLM, the ssm and the encoder-decoder
    runs["vlm"] = vlm_phases(*families)
    ssm_phases(*families)
    audio = audio_phases(*families)
    clock.lap("vlm.ssm.audio")
    for key, r in runs.items():
        kernels[0][f"{key}_launches"] = r["flash_attention"]
        kernels[0][f"{key}_tensor_core_launches"] = r["flash_tensor_core"]
        kernels[1][f"{key}_launches"] = r["paged_decode_attention"]
        kernels[1][f"{key}_split_launches"] = r["paged_split"]
        if "decode_attention_dense_view" in r:
            kernels[2][f"{key}_dense_view_launches"] = \
                r["decode_attention_dense_view"]
    kernels[0]["audio_launches"] = audio["flash_attention"]
    kernels[0]["audio_tensor_core_launches"] = audio["flash_tensor_core"]
    kernels[2]["audio_launches"] = audio["decode_attention"]
    kernels[2]["audio_split_launches"] = audio["decode_split"]
    # the attend-only arms' launches as counted in each path's run (the
    # engines decode in the variant the paged kernel's table names:
    # fused at every paged key of the checked-in table)
    for e in arm_entries:
        count = "paged_" + e["name"].rsplit("_", 1)[1]
        e["launches"] = launches[count]
        e["processor_launches"] = proc[count]
        for key, r in runs.items():
            e[f"{key}_launches"] = r[count]
    kernels.extend(arm_entries)

    # ------------------------------------------- 11. latent attention
    latent = kernels_latent(torch, ld_ops, latent_decode_attention_ref,
                            softmax_scale(dsv2.mla))
    mla = mla_phases(torch, np, tokenizer, InferenceEngine, fa_ops, pd_ops,
                     ld_ops, plain_calls)
    latent["launches"] = mla["latent_decode_attention"]
    kernels[0]["dsv2_launches"] = mla["flash_attention"]
    kernels[0]["dsv2_tensor_core_launches"] = mla["flash_tensor_core"]
    kernels.append(latent)
    clock.lap("mla")

    # ------------------------------------------------- 12. distribution
    dist_res = distribution_phases(torch, da_ops, decode_attention_ref,
                                   plain_calls)
    kernels[2]["distribution_launches"] = dist_res.pop("launches")
    kernels[2]["distribution"] = dist_res
    gc.collect()
    torch.cuda.empty_cache()
    clock.lap("distribution")

    # ----------------------------------------------------- 13. training
    flash_bwd = kernels_flash_bwd(torch, F, fa_ops, flash_attention_bwd_ref,
                                  flash_attention_lse_ref)
    scan_bwd = kernels_scan_bwd(torch, lru_ops, linear_scan_ref,
                                linear_scan_bwd_ref)
    trained = train_phases(torch, np, get_config, build_model, fa_ops,
                           lru_ops, plain_calls)
    main_bwd = flash_bwd.pop("qwen3")
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": f"{csrc}/flash_attention_bwd.cu",
        "replaces": "src/repro/engine/models/layers.py:93 (attention_xla "
                    "under jax.grad; no Pallas backward)",
        "launches": trained["flash_bwd"],
        **{k: main_bwd[k] for k in BWD_KEYS},
        "shapes": {n: {k: r[k] for k in BWD_KEYS}
                   for n, r in flash_bwd.items()}})
    kernels[0]["train_launches"] = trained["flash_train"]
    scan_bwd["launches"] = trained["scan_bwd"]
    kernels.append(scan_bwd)
    gc.collect()
    torch.cuda.empty_cache()
    clock.lap("training")

    # --------------------------------------------------- 14. roofline.card
    roofline_card_phase(torch, get_config, engine_profile, engine_shapes,
                        trained["qwen3_step"])
    clock.lap("roofline.card")

    # --------------------------------------------------- 15. dryrun.sweep
    # after the last timed phase: the dry run needs no card, and its
    # processes would share the host with the timed phases
    import atexit
    import shutil
    sweep_dir = pathlib.Path(tempfile.mkdtemp(prefix="dryrun_sweep_"))
    atexit.register(shutil.rmtree, sweep_dir, ignore_errors=True)
    sweep = DryrunSweep(sweep_dir)
    atexit.register(sweep.kill)
    dryrun_sweep_phase(sweep, SWEEP_BUDGET_S)
    clock.lap("dryrun.sweep")

    # ------------------------------------------------------ 16. the report
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
