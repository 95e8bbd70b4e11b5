"""Training substrate of the port: optimizer, trainer, checkpoints,
gradient compression and the resumable data pipeline (the counterpart of
``repro/training``)."""
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update, cosine_lr)
from repro_torch.training.trainer import (TrainerConfig, make_train_step,
                                          train_loop)
from repro_torch.training.checkpoint import save_checkpoint, load_checkpoint
from repro_torch.training.data import DataConfig, SyntheticLMData

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "cosine_lr",
    "TrainerConfig", "make_train_step", "train_loop",
    "save_checkpoint", "load_checkpoint", "DataConfig", "SyntheticLMData",
]
