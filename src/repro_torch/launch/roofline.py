"""Roofline analysis over the dry run's cells, on the NVIDIA H100 SXM.

The counterpart of ``repro/launch/roofline.py``, with the H100's
constants (``configs/base.py``) in place of the TPU's.  Per (arch x
shape) cell:

    compute term    = FLOPs      / 989e12 FLOP/s  (bf16 tensor cores)
    memory term     = HBM bytes  / 3.35e12 B/s    (HBM3)
    collective term = coll bytes / 450e9 B/s      (NVLink 4, one direction)

The FLOPs, bytes and collective bytes come from the dry run's op-cost
counter (``launch/op_cost.py``, with trip counts) and are per device, so
the terms are per-GPU times.  The dominant term is the bottleneck;
``model_flops`` / counted FLOPs shows remat and redundant work.

The collective term assumes every collective crosses NVLink at one GPU's
rate.  An 8-GPU node holds one NVLink domain, so a 16-wide ``model`` axis
spans two nodes and its traffic crosses InfiniBand (``IB_BW``, 50 GB/s a
GPU) for part of the way: the term is a lower bound there.  There is no
per-axis model of the links, as there is none in the JAX package.

This module is also the port's one source of peak rates: the card's
smoke script prices each kernel with ``kernel_time_bound``.

    python -m repro_torch.launch.roofline [--json] [--dir experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16,
                                      PEAK_FLOPS_F32)

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

# the peak rate of each dtype's operations
PEAK_FLOPS = {"bfloat16": PEAK_FLOPS_BF16, "float32": PEAK_FLOPS_F32}


# ---------------------------------------------------------------------------
# kernel-level speed-of-light (same per-GPU peaks as the roofline above)
# ---------------------------------------------------------------------------

def kernel_time_bound(bytes_hbm: float, flops: float, *,
                      hbm_bw: float = HBM_BW,
                      peak_flops: float = PEAK_FLOPS_BF16) -> float:
    """Speed-of-light seconds for ONE kernel launch: the slower of the
    memory term (every HBM byte once at peak bandwidth) and the compute
    term (every FLOP at peak throughput; pass ``peak_flops=PEAK_FLOPS_F32``
    for a kernel whose operations are f32 on the CUDA cores)."""
    return max(bytes_hbm / hbm_bw, flops / peak_flops)


def pct_of_roofline(measured_s: float, bytes_hbm: float, flops: float, *,
                    hbm_bw: float = HBM_BW,
                    peak_flops: float = PEAK_FLOPS_BF16) -> float:
    """Achieved fraction of the kernel speed-of-light, in percent
    (100 = the launch ran exactly at the roofline bound)."""
    bound = kernel_time_bound(bytes_hbm, flops, hbm_bw=hbm_bw,
                              peak_flops=peak_flops)
    return 100.0 * bound / max(measured_s, 1e-30)


def paged_decode_cost(B: int, H: int, Hkv: int, Dh: int, page_size: int,
                      n_pages: int, *, dtype_bytes: int = 4,
                      fused: bool = False, lengths=None):
    """(HBM bytes, FLOPs) model for one paged-decode attention launch.

    Each live page's KV is streamed once (summed over heads a page's bytes
    are read exactly once); q and out are B*H*Dh terms.  ``fused`` adds
    the appended token's KV write (and saves the separate scatter's round
    trip, which is not in this launch's bytes).  ``lengths`` (default:
    every row full) drives the per-row page count, as the kernels stop at
    a row's last page.
    """
    if lengths is None:
        lengths = [n_pages * page_size - 1] * B
    live = [ln for ln in lengths if ln >= 0]
    pages = sum(ln // page_size + 1 for ln in live)
    kv_bytes = 2 * pages * page_size * Hkv * Dh * dtype_bytes
    qo_bytes = 2 * B * H * Dh * dtype_bytes
    append_bytes = 2 * B * Hkv * Dh * dtype_bytes if fused else 0
    tokens = sum(ln + 1 for ln in live)
    flops = 4.0 * H * Dh * tokens                  # QK^T + PV per token
    return kv_bytes + qo_bytes + append_bytes, flops


def model_flops(arch: str, shape_name: str) -> float:
    """6*N*D (train) / 2*N_active*D (inference), D = processed tokens."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch                    # one decode step
    return 2.0 * n_active * tokens


def analyze_cell(cell: Dict) -> Optional[Dict]:
    if cell.get("status") != "ok":
        return None
    n_dev = cell["devices"]
    flops = cell["flops"]                          # per device
    byts = cell["bytes_accessed"]
    coll = cell["collectives"].get("collective_bytes", 0.0)
    t_compute = flops / PEAK_FLOPS_BF16
    t_memory = byts / HBM_BW
    t_coll = coll / NVLINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cell["arch"], cell["shape"]) / n_dev
    bound = max(terms.values())
    return {
        "arch": cell["arch"], "shape": cell["shape"], "mesh": cell["mesh"],
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops_per_dev": mf, "counted_flops_per_dev": flops,
        "useful_flop_ratio": mf / max(flops, 1.0),
        # useful work at peak against the bound the counted program hits
        "roofline_fraction": (mf / PEAK_FLOPS_BF16) / max(bound, 1e-30),
        "hbm_fit": cell.get("hbm_fit"),
    }


def load_cells(dirname: str, mesh: str = "pod16x16") -> List[Dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(path) as f:
            c = json.load(f)
        if c.get("mesh") == mesh:
            cells.append(c)
    return cells


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=OUT_DIR)
    ap.add_argument("--mesh", default="pod16x16")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    rows = []
    skipped = []
    for cell in load_cells(args.dir, args.mesh):
        r = analyze_cell(cell)
        if r is None:
            skipped.append((cell["arch"], cell["shape"],
                            cell.get("reason", cell.get("error", ""))[:60]))
            continue
        rows.append(r)

    if args.json:
        print(json.dumps(rows, indent=1))
        return 0

    print(f"H100 SXM: {PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s bf16, "
          f"{HBM_BW / 1e12:.2f} TB/s HBM, {NVLINK_BW / 1e9:.0f} GB/s NVLink "
          f"a direction; seconds a device, mesh {args.mesh}")
    hdr = (f"{'arch':20s} {'shape':12s} {'compute':>10s} {'memory':>10s} "
           f"{'collect':>10s} {'dominant':>10s} {'useful':>7s} {'roofl%':>7s} fit")
    print(hdr)
    print("-" * len(hdr))
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        print(f"{r['arch']:20s} {r['shape']:12s} "
              f"{r['t_compute_s']:10.4f} {r['t_memory_s']:10.4f} "
              f"{r['t_collective_s']:10.4f} {r['dominant']:>10s} "
              f"{r['useful_flop_ratio']:7.2f} "
              f"{100*r['roofline_fraction']:6.1f}% {r['hbm_fit']}")
    if skipped:
        print("\nskipped cells:")
        for a, s, why in skipped:
            print(f"  {a:20s} {s:12s} {why}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
