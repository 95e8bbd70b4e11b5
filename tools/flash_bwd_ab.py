#!/usr/bin/env python3
"""A/B variants of the flash backward's tensor-core body, on one card.

    python3 tools/flash_bwd_ab.py [--only base,nocopy] [--shapes qwen3,...]

Builds ``src/repro_torch/kernels/csrc/flash_attention_bwd.cu`` as it
stands and in variants made by text patches of it, each into its own
library under ``src/repro_torch/kernels/build/bwd_ab/`` (one ``nvcc``
each, all started together), then times ``flash_attention_bwd`` in bf16
at ``chip_smoke.FLASH_BWD_SHAPES``: the profiler's device milliseconds per
call, by kernel, and the largest difference from the base variant's
gradients, the variants in the order ``--only`` names them.  Variants:

* ``base``: the source as it is;
* ``nocopy``: the walks issue no copies after their first step's (the
  tiles stay stale): the time of the products, the elementwise work and
  the synchronisation alone;
* ``noproducts``: no tensor-core product is issued: the time of the
  copies, the elementwise work and the synchronisation;
* ``noboth``: neither: the elementwise work and the synchronisation;
* ``noexp``: P taken as its exponent, no ``ex2``;
* ``nofence``: no proxy fence between the copies and the products;
* ``onestep``: each block stops after its first visited step: the blocks'
  set-up and write-out with one step;
* ``ring3``: walk 2's ring three steps deep at Dh 128.

A variant's gradients are wrong by design except ``base``'s.  Needs a
CUDA card and ``nvcc``; imports nothing of JAX.
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
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
CSRC = ROOT / "src/repro_torch/kernels/csrc"


def _patch(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            return src                      # the variant no longer applies
        src = src.replace(old, new)
    return src


NOCOPY = [
    ("  auto load_kv = [&](int t, int stage) {\n",
     "  auto load_kv = [&](int t, int stage) {\n    if (t > 0) return;\n"),
    ("  auto load_step = [&](int st, int stage) {\n",
     "  auto load_step = [&](int st, int stage) {\n    if (st > 0) return;\n")]
NOPRODUCTS = [
    ("  wgmma_fence();\n#pragma unroll\n  for (int x = 0; x < KK; ++x)",
     "  if (KK > 0) return;\n  wgmma_fence();\n#pragma unroll\n"
     "  for (int x = 0; x < KK; ++x)"),
    ("        wgmma_rs(dv_acc,", "        if (0) wgmma_rs(dv_acc,"),
    ("        wgmma_rs(dk_acc, ah", "        if (0) wgmma_rs(dk_acc, ah"),
    ("        wgmma_rs(dk_acc, al", "        if (0) wgmma_rs(dk_acc, al"),
    ("          wgmma_rs(acc, ah", "          if (0) wgmma_rs(acc, ah"),
    ("          wgmma_rs(acc, al", "          if (0) wgmma_rs(acc, al")]
NOEXP = [("__device__ __forceinline__ float exp2_approx(float x) {\n",
          "__device__ __forceinline__ float exp2_approx(float x) {\n"
          "  if (x < 1e30f) return x;\n")]
NOFENCE = [("      fence_async_shared();\n", "")]
RING3 = [  # walk 2 three steps deep at Dh 128 (its smem stays under walk 3's)
    ("  constexpr int NS = kStages;\n  return 1024 +\n"
     "         sizeof(bf16) * (2 * (size_t)kKeyTile * DH",
     "  constexpr int NS = DH == 128 ? 3 : kStages;\n  return 1024 +\n"
     "         sizeof(bf16) * (2 * (size_t)kKeyTile * DH"),
    ("  constexpr int NS = kStages;\n  bf16* k_s",
     "  constexpr int NS = DH == 128 ? 3 : kStages;\n  bf16* k_s")]
ONESTEP = [("    for (int i = 0; i < n; ++i) {\n",
            "    for (int i = 0; i < (n < 1 ? n : 1); ++i) {\n")]


def variants(src: str) -> dict:
    out = {"base": src,
           "nocopy": _patch(src, NOCOPY),
           "noproducts": _patch(src, NOPRODUCTS),
           "noboth": _patch(src, NOCOPY + NOPRODUCTS),
           "noexp": _patch(src, NOEXP),
           "nofence": _patch(src, NOFENCE),
           "onestep": _patch(src, ONESTEP),
           "ring3": _patch(src, RING3)}
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
        regs = [ln.split("Used ")[1].split(",")[0] for ln in log.splitlines()
                if "Used " in ln and "registers" in ln]
        lib = ctypes.CDLL(str(out_dir / name / "lib.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_bwd.argtypes = [p] * 11 + [i] * 11 + [p]
        lib.flash_attention_bwd.restype = i
        lib.flash_attention_bwd_workspace.argtypes = [i] * 8
        lib.flash_attention_bwd_workspace.restype = ctypes.c_longlong
        libs[name] = lib
        print(json.dumps({"variant": name, "registers": regs}), flush=True)
    return libs


def by_kernel(torch, fn, n=10):
    """Device ms per call of each kernel (the profiler's), and their sum."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        per = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = e.name.replace("void ", "").replace(
                    "(anonymous namespace)::", "").split("(")[0]
                per[name] = per.get(name, 0.0) + e.time_range.elapsed_us()
        if per:
            return ({k: round(v / n / 1e3, 4) for k, v in per.items()},
                    round(sum(per.values()) / n / 1e3, 4))
    return {}, None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="")
    ap.add_argument("--shapes", default="")
    args = ap.parse_args()
    texts = variants((CSRC / "flash_attention_bwd.cu").read_text())
    names = [n for n in args.only.split(",") if n in texts] \
        if args.only else list(texts)
    print(json.dumps({"variants": names}), flush=True)
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.common import sm_count
    from repro_torch.kernels.flash_attention import ops as fa_ops
    if not torch.cuda.is_available():
        print("flash_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    print(cs.nvidia_smi_line(), flush=True)
    libs = build_all(names, texts,
                     ROOT / "src/repro_torch/kernels/build/bwd_ab")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    for (name, B, Sq, Skv, H, Hkv, Dh, causal, window,
         valid) in cs.FLASH_BWD_SHAPES:
        if args.shapes and name not in args.shapes.split(","):
            continue
        q, do = (torch.randn(B, Sq, H, Dh, generator=gen, device=dev,
                             dtype=torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(B, Skv, Hkv, Dh, generator=gen, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        qp = torch.arange(Sq, dtype=torch.int32, device=dev).expand(
            B, Sq).contiguous() + (Skv - Sq if causal else 0)
        kp = torch.arange(Skv, dtype=torch.int32, device=dev)[None]
        kp = torch.where(kp < valid, kp, -1).expand(B, Skv).to(
            torch.int32).contiguous()
        _, lse = fa_ops.flash_attention_lse(
            q, k, v, q_positions=qp, kv_positions=kp, causal=causal,
            window=window)
        n_split = fa_ops.bwd_head_split(B, Skv, Hkv, H // Hkv,
                                        sm_count(dev.index or 0))
        base = None
        for vname, lib in libs.items():
            outs = [torch.empty_like(t) for t in (q, k, v)]
            ws = torch.empty(lib.flash_attention_bwd_workspace(
                B, Sq, Skv, H, Hkv, Dh, 1, n_split), dtype=torch.uint8,
                device=dev)

            def run():
                err = lib.flash_attention_bwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), qp.data_ptr(), kp.data_ptr(),
                    *(t.data_ptr() for t in outs), ws.data_ptr(), B, Sq,
                    Skv, H, Hkv, Dh, int(causal), int(window), 1, 1,
                    n_split, torch.cuda.current_stream().cuda_stream)
                assert err == 0, err

            run()
            torch.cuda.synchronize()
            if base is None:
                base = [t.clone() for t in outs]
            diff = max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(outs, base))
            per, total = by_kernel(torch, run)
            print(json.dumps({"shape": name, "variant": vname,
                              "device_ms": total, "by_kernel": per,
                              "max_diff_from_base": f"{diff:.3e}"}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
