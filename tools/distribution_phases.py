#!/usr/bin/env python3
"""The ``[distribution.*]`` phases of ``chip_smoke.py`` alone, on one card.

    python3 tools/distribution_phases.py

Builds the kernels, runs ``chip_smoke.distribution_phases`` (the sharded
decode at world size 1 and over four processes sharing the card, the
compressed all-reduce on those four) and ``distribution_checkpoint`` on a
checkpoint of a 4-layer full-width qwen3-1.7b that two ``train_loop``
steps write here (in ``chip_smoke.py`` it loads ``[train.checkpoint]``'s),
and prints the phase lines and one JSON line of the phase's numbers.
About a minute with the build; for iterating on ``repro_torch.distribution``.
Needs a CUDA card; imports no JAX.
"""
import json
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("distribution_phases: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.training import (AdamWConfig, DataConfig, TrainerConfig,
                                      adamw_init, train_loop)

    t0 = time.perf_counter()
    print(cs.nvidia_smi_line())
    _, plain_calls = cs.card_setup(torch, np)
    print(f"build_s {build.build_seconds:.3f}")
    res = cs.distribution_phases(torch, da_ops, decode_attention_ref,
                                 plain_calls)
    cfg = get_config("qwen3-1.7b").replace(num_layers=4)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=2)
    with tempfile.TemporaryDirectory() as d:
        out = train_loop(cfg, TrainerConfig(adamw=AdamWConfig(
            total_steps=2)), dcfg, num_steps=2, ckpt_dir=d, ckpt_every=2,
            seed=3, log_every=100)
        params = dict(out["model"].named_parameters())
        cs.distribution_checkpoint(torch, str(pathlib.Path(d) /
                                              "step_000000002"),
                                   cfg, (params, adamw_init(params)))
    print(json.dumps(res))
    print(f"wall_s {time.perf_counter() - t0:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
