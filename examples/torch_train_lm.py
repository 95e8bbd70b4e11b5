"""Train a ~100M-parameter LM for a few hundred steps on the port.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300 \\
        [--device cpu]

Exercises the port's training substrate: AdamW + cosine schedule, remat,
grad accumulation, atomic checkpointing with resume, deterministic data
(``examples/train_lm.py`` does the same through the JAX package).  It
trains on the card (``--device cuda``, the default; it raises without
one) or, asked for, on the CPU.
"""
import argparse
import os
import tempfile
from typing import Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.training import (AdamWConfig, DataConfig, TrainerConfig,
                                  train_loop)

# ~100M params: 12 layers, d=768, tied embeddings over a 32k vocab
CFG_100M = ModelConfig(
    name="repro-100m", family="dense", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=4, d_ff=2048, vocab_size=32768,
    head_dim=64, tie_embeddings=True, rope_theta=10000.0)


def main(argv: Optional[Sequence[str]] = None,
         cfg: Optional[ModelConfig] = None) -> dict:
    """Train ``cfg`` (``CFG_100M`` unless given) and return
    ``train_loop``'s output."""
    cfg = cfg or CFG_100M
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "halo_train_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError("torch_train_lm: device 'cuda' requested but no "
                           "CUDA device is available; pass --device cpu")

    print(f"model: {cfg.param_count()/1e6:.0f}M params")
    tcfg = TrainerConfig(remat=True, grad_accum=2, adamw=AdamWConfig(
        lr=6e-4, warmup_steps=max(args.steps // 20, 10),
        total_steps=args.steps))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, structure=0.85)
    out = train_loop(cfg, tcfg, dcfg, num_steps=args.steps,
                     ckpt_dir=args.ckpt_dir, ckpt_every=100,
                     log_every=max(args.steps // 30, 1), device=args.device)
    first, last = out["losses"][0][1], out["losses"][-1][1]
    print(f"\nloss {first:.3f} -> {last:.3f} over {args.steps} steps "
          f"({out['seconds']:.0f}s); checkpoints in {args.ckpt_dir}")
    return out


if __name__ == "__main__":
    main()
