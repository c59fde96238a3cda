from .distill import (
    LiveTeacher,
    TeacherScores,
    distill_soft_ce,
    evenly_spaced_layers,
    init_student_from_teacher,
    match_logodds,
    model_batch_of,
    stacking_layer_map,
    teacher_logodds,
)
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
    "LiveTeacher",
    "TeacherScores",
    "TrainConfig",
    "TrainState",
    "Trainer",
    "clip_by_global_norm",
    "clip_by_value",
    "decay_mask",
    "distill_soft_ce",
    "evenly_spaced_layers",
    "exponential_staircase_schedule",
    "grad_group_norms",
    "init_student_from_teacher",
    "make_loss_fn",
    "match_logodds",
    "model_batch_of",
    "ms_loss",
    "polynomial_warmup_schedule",
    "recipe_for",
    "stacking_layer_map",
    "teacher_logodds",
]
