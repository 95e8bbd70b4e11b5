"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

The JAX package's flags, plus ``--device`` (``cuda`` by default; it
raises without a card, ``--device cpu`` runs on the CPU).  The smoke
config is the default and ``--full-config`` takes the arch's full config,
as in the JAX launcher: on the card,

    python -m repro_torch.launch.train --arch qwen3-1.7b --full-config \\
        --steps 20 --batch 8 --seq 512

trains full-width qwen3-1.7b from random weights (``--seed``).  It exits
0 when the last logged loss is below the first.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.configs import get_config, get_smoke
from repro_torch.training import (AdamWConfig, DataConfig, TrainerConfig,
                                  train_loop)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--full-config", action="store_true",
                    help="use the arch's full config (default: the smoke "
                    "config)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full_config else get_smoke(args.arch)
    tcfg = TrainerConfig(
        remat=True, grad_accum=args.grad_accum,
        adamw=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                          total_steps=args.steps))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)
    out = train_loop(cfg, tcfg, dcfg, num_steps=args.steps,
                     ckpt_dir=args.ckpt_dir,
                     log_every=max(args.steps // 20, 1), seed=args.seed,
                     device=args.device)
    first, last = out["losses"][0][1], out["losses"][-1][1]
    print(f"\narch={cfg.name} steps={args.steps} device={args.device} "
          f"loss {first:.4f} -> {last:.4f} in {out['seconds']:.1f}s")
    return 0 if last < first else 1


if __name__ == "__main__":
    raise SystemExit(main())
