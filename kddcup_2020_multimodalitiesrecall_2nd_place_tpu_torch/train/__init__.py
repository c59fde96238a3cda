from .ema import Ema
from .losses import ms_loss
from .optim import (
    Adam,
    BertAdamW,
    clip_by_global_norm,
    clip_by_value,
    decay_mask,
    exponential_staircase_schedule,
    grad_group_norms,
    polynomial_warmup_schedule,
)
from .trainer import Trainer, TrainConfig, TrainState, make_loss_fn, recipe_for

__all__ = [
    "Adam",
    "BertAdamW",
    "Ema",
    "TrainConfig",
    "TrainState",
    "Trainer",
    "clip_by_global_norm",
    "clip_by_value",
    "decay_mask",
    "exponential_staircase_schedule",
    "grad_group_norms",
    "make_loss_fn",
    "ms_loss",
    "polynomial_warmup_schedule",
    "recipe_for",
]
