"""Resumable deterministic LM data pipeline: a copy of
``repro/training/data.py`` (numpy only), held equal to it by
``tests/test_torch_copies.py``.

Batches are a pure function of (seed, step): restart at step k
reproduces exactly the stream a continuous run would have seen, so a
resumed run trains on the same batches as a continuous one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # lightweight structure so the loss actually falls during smoke
    # training: tokens follow a noisy arithmetic progression
    structure: float = 0.8


class SyntheticLMData:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int, host_id: int = 0,
                 num_hosts: int = 1) -> Dict[str, np.ndarray]:
        """The (host-sharded) batch for one global step — pure function."""
        cfg = self.cfg
        assert cfg.global_batch % num_hosts == 0
        per_host = cfg.global_batch // num_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, host_id]))
        base = rng.integers(0, cfg.vocab_size,
                            size=(per_host, 1), dtype=np.int32)
        stride = rng.integers(1, 7, size=(per_host, 1), dtype=np.int32)
        pos = np.arange(cfg.seq_len, dtype=np.int32)[None, :]
        seq = (base + stride * pos) % cfg.vocab_size
        noise_mask = rng.random((per_host, cfg.seq_len)) > cfg.structure
        noise = rng.integers(0, cfg.vocab_size,
                             size=(per_host, cfg.seq_len), dtype=np.int32)
        tokens = np.where(noise_mask, noise, seq).astype(np.int32)
        return {"tokens": tokens, "labels": tokens}

    def stream(self, start_step: int = 0, host_id: int = 0,
               num_hosts: int = 1) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step, host_id, num_hosts)
            step += 1

    def skip_ahead(self, current_step: int) -> int:
        """Straggler mitigation: resume from the fleet's current step."""
        return current_step
