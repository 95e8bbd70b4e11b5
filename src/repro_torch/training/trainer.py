"""Train-step factory and loop.

The counterpart of ``repro/training/trainer.py``.  ``make_train_step``
builds a step over a model whose parameters require grad: the model's
``loss_fn`` (with ``remat``, each block rematerialized in the backward),
autograd through it (on the card the flash and scan kernels with their
hand-written backward), then ``adamw_update``, which writes the
parameters in place.  With ``grad_accum > 1`` the batch is split into
microbatches along its first axis, each one's gradients are added into
float32 sums (never into a bfloat16 ``.grad``), and the sums are divided
by their count, as the JAX step does.

``train_loop`` runs on the card unless the caller asks for the CPU; it
draws the weights from a ``torch.Generator`` seeded with ``seed`` (other
numbers than the JAX package's draws from the same seed), resumes from
the newest committed checkpoint, and logs loss, learning rate and
gradient norm as the JAX loop does.  It reads every step's metrics back
to the host (one synchronisation a step, which the step time includes)
and returns them with each step's seconds.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.engine.models import build_model
from repro_torch.training.checkpoint import (latest_checkpoint,
                                             load_checkpoint,
                                             save_checkpoint)
from repro_torch.training.data import DataConfig, SyntheticLMData
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update)

Tensors = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class TrainerConfig:
    remat: bool = True
    grad_accum: int = 1             # microbatches per step
    adamw: AdamWConfig = AdamWConfig()


def loss_and_grads(model, batch: Tensors, remat: bool = False,
                   impl: Optional[str] = None) -> Tuple[torch.Tensor,
                                                       Tensors]:
    """The model's loss on ``batch`` and its gradient for every parameter
    (zeros for one the loss does not reach), keyed by parameter name."""
    params = dict(model.named_parameters())
    loss = model.loss_fn(batch, remat=remat, impl=impl)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return loss.detach(), {
        n: torch.zeros_like(p) if g is None else g
        for (n, p), g in zip(params.items(), grads)}


def make_train_step(model, tcfg: TrainerConfig, impl: Optional[str] = None
                    ) -> Callable[[Dict, Tensors], Tuple[Dict, Tensors]]:
    """``train_step(opt_state, batch) -> (opt_state, metrics)`` for
    ``model`` (whose parameters must require grad); metrics ``{"loss",
    "grad_norm", "lr"}`` as tensors."""
    params = dict(model.named_parameters())

    def grads_of(batch):
        return loss_and_grads(model, batch, remat=tcfg.remat, impl=impl)

    def train_step(opt_state, batch):
        n = tcfg.grad_accum
        if n > 1:
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            grads = {k: torch.zeros_like(p, dtype=torch.float32)
                     for k, p in params.items()}
            for i in range(n):
                micro = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                         for k, v in batch.items()}
                mloss, mgrads = grads_of(micro)
                loss = loss + mloss
                for k, g in mgrads.items():
                    grads[k] += g
                del mgrads
            loss = loss / n
            grads = {k: g / n for k, g in grads.items()}
        else:
            loss, grads = grads_of(batch)
        _, opt_state, om = adamw_update(tcfg.adamw, params, grads, opt_state)
        return opt_state, {"loss": loss, **om}

    return train_step


def train_loop(cfg: ModelConfig, tcfg: TrainerConfig, data_cfg: DataConfig,
               num_steps: int, ckpt_dir: Optional[str] = None,
               ckpt_every: int = 50, log_every: int = 10, seed: int = 0,
               resume: bool = True, device="cuda",
               impl: Optional[str] = None) -> Dict[str, Any]:
    """Single-process training loop with checkpoint/restart.

    Returns ``{"losses": [(step, loss)] at the logged steps, "history":
    [{"step", "loss", "lr", "grad_norm", "seconds"}] for every step run,
    "model", "params", "opt_state", "seconds"}``.  A checkpoint is saved
    every ``ckpt_every`` steps and at the end (once, where the two
    coincide)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_loop: device 'cuda' requested but no CUDA "
                           "device is available; pass device='cpu' to run "
                           "on the CPU")
    model = build_model(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(seed))
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    opt_state = adamw_init(params)
    step0 = 0
    if ckpt_dir and resume:
        latest = latest_checkpoint(ckpt_dir)
        if latest:
            step0, loaded, opt_state, _ = load_checkpoint(
                latest, (params, opt_state))
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(loaded[n])
            del loaded

    step_fn = make_train_step(model, tcfg, impl)
    data = SyntheticLMData(data_cfg)
    losses, history = [], []
    saved = None
    t0 = time.perf_counter()
    for step in range(step0, num_steps):
        ts = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch_at(step).items()}
        opt_state, metrics = step_fn(opt_state, batch)
        row = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        row["seconds"] = time.perf_counter() - ts
        history.append(row)
        if step % log_every == 0 or step == num_steps - 1:
            losses.append((step, row["loss"]))
            print(f"step {step:5d}  loss {row['loss']:.4f}  "
                  f"lr {row['lr']:.2e}  gnorm {row['grad_norm']:.3f}")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, step + 1, params, opt_state)
            saved = step + 1
    if ckpt_dir and saved != num_steps:
        save_checkpoint(ckpt_dir, num_steps, params, opt_state)
    return {"losses": losses, "history": history, "model": model,
            "params": params, "opt_state": opt_state,
            "seconds": time.perf_counter() - t0}
