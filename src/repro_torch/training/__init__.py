"""Training: AdamW with the warmup-cosine schedule, the loss and the train
step (microbatches, remat, the bf16 weight cast)."""

from repro_torch.training.optimizer import (
    OPTIMIZER_RANGE,
    OptimizerConfig,
    apply_updates,
    global_norm,
    init_opt_state,
    schedule,
)
from repro_torch.training.train import TrainConfig, TrainStep, batch_to, lm_loss, make_train_step

__all__ = [
    "OPTIMIZER_RANGE",
    "OptimizerConfig",
    "TrainConfig",
    "TrainStep",
    "apply_updates",
    "batch_to",
    "global_norm",
    "init_opt_state",
    "lm_loss",
    "make_train_step",
    "schedule",
]
