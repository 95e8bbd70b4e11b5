#!/usr/bin/env python3
"""The backward-kernel and training phases of ``chip_smoke.py`` alone, on
one card.

    python3 tools/train_phases.py [kernels] [train]

Runs ``chip_smoke.kernels_flash_bwd`` and ``kernels_scan_bwd``
(``kernels``) and ``chip_smoke.train_phases`` (``train``), both by
default, with the plain versions counted as ``chip_smoke.py`` counts them
(none may run on the training path), and prints their phase lines and
the backward kernels' numbers as one JSON line.  It takes about two
minutes against the whole script's seven, for iterating on the backward
kernels and the trainer.  Needs a CUDA card; imports no JAX.
"""
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_phases: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.engine.models import build_model
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_lse_ref)
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.kernels.rglru_scan.ref import (linear_scan_bwd_ref,
                                                   linear_scan_ref)

    t0 = time.perf_counter()
    print(cs.nvidia_smi_line())
    _, plain_calls = cs.card_setup(torch, np)
    print(f"build_s {build.build_seconds:.3f}")

    which = sys.argv[1:] or ["kernels", "train"]
    if "kernels" in which:
        fb = cs.kernels_flash_bwd(torch, F, fa_ops, flash_attention_bwd_ref,
                                  flash_attention_lse_ref)
        sb = cs.kernels_scan_bwd(torch, lru_ops, linear_scan_ref,
                                 linear_scan_bwd_ref)
        print(json.dumps({"flash_bwd": fb, "scan_bwd": sb}))
    if "train" in which:
        print(json.dumps(cs.train_phases(torch, np, get_config, build_model,
                                         fa_ops, lru_ops, plain_calls)))
    print(f"wall_s {time.perf_counter() - t0:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
