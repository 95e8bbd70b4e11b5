#!/usr/bin/env python3
"""The phases of ``chip_smoke.py`` that serve mixtral-8x22b and
deepseek-67b, alone, on one card.

    python3 tools/swa_phases.py [kernels] [deepseek] [mixtral]

``kernels`` runs ``chip_smoke.kernels_at_grouping`` at the two models'
head groupings (64 and 48 query heads over 8 KV heads) and
``chip_smoke.kernels_swa`` (flash at mixtral's 4500-token windowed
prefill, the decode kernel over its wrapped 4096-slot ring);
``deepseek`` the dense-family phase on deepseek-67b cut to 40 layers;
``mixtral`` ``chip_smoke.swa_phases``: all three by default, with the
plain versions counted as ``chip_smoke.py`` counts them (none may run on
the served paths).  Prints their phase lines and the kernels' numbers as
one JSON line, for iterating on these phases without the whole script.
Needs a CUDA card; imports no JAX.
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
        print("swa_phases: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.engine import tokenizer
    from repro_torch.engine.engine import InferenceEngine
    from repro_torch.engine.models import build_model
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_decode_attention import ops as pd_ops

    t0 = time.perf_counter()
    print(cs.nvidia_smi_line())
    t, plain_calls = cs.card_setup(torch, np)
    print(f"build_s {build.build_seconds:.3f}")

    which = sys.argv[1:] or ["kernels", "deepseek", "mixtral"]
    out = {}
    if "kernels" in which:
        rng = np.random.default_rng(11)
        out["groups"] = {arch: cs.kernels_at_grouping(torch, F, rng, arch, H,
                                                      Hkv)
                         for arch, H, Hkv in cs.GROUPINGS[-2:]}
        out["swa"] = cs.kernels_swa(torch, F, t, rng, fa_ops, da_ops,
                                    flash_attention_ref,
                                    decode_attention_ref)
    if "deepseek" in which:
        out["deepseek_67b"] = cs.dense_family_phase(
            torch, np, "deepseek-67b", get_config, tokenizer,
            InferenceEngine, fa_ops, pd_ops, da_ops, plain_calls, layers=40)
    if "mixtral" in which:
        out["mixtral"] = cs.swa_phases(
            torch, np, get_config, tokenizer, InferenceEngine, build_model,
            fa_ops, pd_ops, da_ops, plain_calls)
    print(json.dumps(out))
    print(f"wall_s {time.perf_counter() - t0:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
