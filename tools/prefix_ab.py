#!/usr/bin/env python3
"""A/B variants of the shared-prefix kernel's tensor-core body, on one card.

    python3 tools/prefix_ab.py [--chunks 128,256] [--only base,timeline]
                               [--extra other.cu,...]

Builds ``src/repro_torch/kernels/csrc/shared_prefix_attention.cu`` as it
stands and in variants made by text patches of it, each into its own
library under ``src/repro_torch/kernels/build/ab/`` (one ``nvcc`` each, all
started together), then times ``prefix_attention_fwd`` at qwen3-1.7b's
width (H=16, Hkv=8, Dh=128, bf16, P=2048, eight layers cycled past the L2)
for B=8 and B=32 at each chunk given: the profiler's device microseconds
per call and the largest error against the plain version.  Variants:

* ``base``: the source as it is;
* ``walkonly``: each block returns after its walk over the keys (no
  merges, nothing written): the walk's own time;
* ``c{2,4,8}s{2,4}``: clusters of 2, 4 or 8 chunks, rings of 2 or 4 tiles;
* ``mt2``, ``mt4``: two or four m16 row tiles a block even at B*G <= 16;
* ``timeline``: ``%globaltimer`` stamps by thread 0 of every block (start,
  walk end, block merge done, cluster merge start and done, ticket won,
  end); prints (min, median, max) ns after the earliest start;
* each ``--extra`` file, a whole source with the same C entry, named by
  its stem, with its own ``timeline`` variant (``<stem>_timeline``).

Needs a CUDA card and ``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
CSRC = ROOT / "src/repro_torch/kernels/csrc"
STAMPS = ("start", "walk_end", "block_merge_done", "cluster_merge_start",
          "cluster_merge_done", "ticket_won", "end")


def _stamp(k: int) -> str:
    return ("  if (threadIdx.x == 0) g_stamps[((size_t)(blockIdx.z * gridDim.y"
            f" + blockIdx.y) * gridDim.x + blockIdx.x) * 8 + {k}] = "
            "globaltimer();\n")


def _timeline(src: str) -> str:
    src = src.replace('#include "common.cuh"\n', '''#include "common.cuh"
__device__ unsigned long long g_stamps[1 << 16];
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long x;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(x));
  return x;
}
extern "C" int read_stamps(void* h) {
  return (int)cudaMemcpyFromSymbol(h, g_stamps, sizeof(g_stamps));
}
''', 1)
    marks = [("  const int n_tiles = max(0, (kend - kbeg + BN - 1) / BN);\n", 0,
              True),
             ("  __syncthreads();                          // the ring is free\n",
              1, True),
             ("  cluster.sync();\n  const int rank", 2, False),
             ("  const int rank = (int)cluster.block_rank();\n", 3, True),
             ("  if (n_clusters == 1) return;\n\n", 4, False),
             ("  if (!last_s) return;\n", 5, True)]
    for anchor, k, after in marks:
        assert anchor in src, anchor
        src = src.replace(anchor, anchor + _stamp(k) if after
                          else _stamp(k) + anchor, 1)
    end = ("    for (int j = 0; j < 4; ++j) res.put(qrow, c4 * 4 + j, a[j], mm,"
           " ll);\n  }\n")
    i = src.rindex(end) + len(end)
    return src[:i] + "  __syncthreads();\n" + _stamp(6) + src[i:]


def variants(src: str) -> dict:
    out = {"base": src,
           "walkonly": src.replace(
               "  __syncthreads();                          // the ring is "
               "free\n", "  __syncthreads();\n  if (P > 0) return;\n"),
           "mt2": src.replace("  if (R <= 16)\n", "  if (R <= 0)\n"),
           "mt4": src.replace("  if (R <= 16)\n", "  if (R <= 0)\n")
                     .replace("  if (R <= 32)\n", "  if (R <= 0)\n"),
           "timeline": _timeline(src)}
    for cl in (2, 4, 8):
        for st in (2, 4):
            out[f"c{cl}s{st}"] = src.replace(
                "constexpr int kCluster = 8;", f"constexpr int kCluster = {cl};"
            ).replace("constexpr int kStages = 4;",
                      f"constexpr int kStages = {st};")
    return {k: v for k, v in out.items() if k == "base" or v != src}


def build_all(names, texts, out_dir):
    from repro_torch.kernels import build
    procs = {}
    for name in names:
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "k.cu").write_text(texts[name])
        shutil.copy(CSRC / "common.cuh", d / "common.cuh")
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
             str(d / "lib.so"), str(d / "k.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes")]
        lib = ctypes.CDLL(str(out_dir / name / "lib.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.prefix_attention_fwd.argtypes = [p] * 13 + [i] * 8 + [p]
        lib.prefix_attention_fwd.restype = i
        if name.endswith("timeline"):
            lib.read_stamps.argtypes = [p]
            lib.read_stamps.restype = i
        libs[name] = lib
        print(json.dumps({"variant": name, "spills": spills}), flush=True)
    return libs


def device_us(torch, fn, n=32):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us:
            return round(us / n, 2)
    return None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", default="256")
    ap.add_argument("--only", default="")
    ap.add_argument("--extra", default="")
    ap.add_argument("--dry", action="store_true",
                    help="list the variants that apply and stop")
    args = ap.parse_args()
    texts = variants((CSRC / "shared_prefix_attention.cu").read_text())
    for path in filter(None, args.extra.split(",")):
        stem = pathlib.Path(path).stem
        texts[stem] = pathlib.Path(path).read_text()
        texts[f"{stem}_timeline"] = _timeline(texts[stem])
    names = [n for n in texts if not args.only or n in args.only.split(",")]
    print(json.dumps({"variants": names}), flush=True)
    if args.dry:
        return 0
    import numpy as np
    import torch
    from repro_torch.kernels.shared_prefix_attention.ref import (
        prefix_attention_ref)
    if not torch.cuda.is_available():
        print("prefix_ab: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = build_all(names, texts, ROOT / "src/repro_torch/kernels/build/ab")
    dev = torch.device("cuda")
    H, Hkv, Dh, P, NL = 16, 8, 128, 2048, 8
    gen = torch.Generator(device=dev).manual_seed(13)
    pk = [torch.randn((P, Hkv, Dh), generator=gen, device=dev,
                      dtype=torch.bfloat16) for _ in range(NL)]
    pv = [torch.randn((P, Hkv, Dh), generator=gen, device=dev,
                      dtype=torch.bfloat16) for _ in range(NL)]
    pos = torch.arange(P, dtype=torch.int32, device=dev)
    for B in (8, 32):
        q = torch.randn((B, H, Dh), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        R = B * (H // Hkv)
        want = prefix_attention_ref(q, pk[0], pv[0], pos)
        for name, lib in libs.items():
            for chunk in (int(c) for c in args.chunks.split(",")):
                n_chunks = -(-P // chunk)
                part = torch.empty(n_chunks * Hkv * R * (Dh + 2), device=dev)
                tickets = torch.zeros(1024, dtype=torch.int32, device=dev)
                outs = torch.empty(B * H * (Dh + 2), device=dev)
                acc = outs[:B * H * Dh].view(B, H, Dh)
                m, l = outs[B * H * Dh:].view(2, B, H).unbind(0)
                layer = [0]

                def run(i=None):
                    if i is None:
                        i = layer[0] = (layer[0] + 1) % NL
                    err = lib.prefix_attention_fwd(
                        q.data_ptr(), pk[i].data_ptr(), pv[i].data_ptr(),
                        None, part.data_ptr(), tickets.data_ptr(),
                        acc.data_ptr(), m.data_ptr(), l.data_ptr(), None,
                        None, None, None, B, P, H, Hkv, Dh, chunk, 1, 1,
                        torch.cuda.current_stream().cuda_stream)
                    assert err == 0, err

                run(0)
                torch.cuda.synchronize()
                err = max((a - b).abs().max().item()
                          for a, b in zip((acc, m, l), want))
                print(json.dumps({"variant": name, "B": B, "chunk": chunk,
                                  "device_us": device_us(torch, run),
                                  "max_abs_err_acc_m_l": f"{err:.2e}"}),
                      flush=True)
                if not name.endswith("timeline"):
                    continue
                run()
                torch.cuda.synchronize()
                h = np.zeros(1 << 16, np.uint64)
                assert lib.read_stamps(ctypes.c_void_p(h.ctypes.data)) == 0
                n_blocks = Hkv * -(-n_chunks // 8) * 8 * -(-R // 64)
                d = h[:n_blocks * 8].reshape(n_blocks, 8).astype(np.int64)
                d = np.where(d > 0, d - d[:, 0].min(), -1)
                row = {}
                for k, what in enumerate(STAMPS):
                    v = d[:, k][d[:, k] >= 0]
                    row[what] = [int(v.min()), int(np.median(v)),
                                 int(v.max())] if len(v) else None
                print(json.dumps({"timeline_ns": row, "B": B,
                                  "chunk": chunk}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
