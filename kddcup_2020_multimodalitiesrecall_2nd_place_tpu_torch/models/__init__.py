from .core import (
    KERNEL_BLOCKS,
    PLAIN_BLOCKS,
    TRAIN_KERNEL_BLOCKS,
    TRAIN_PLAIN_BLOCKS,
    BertConfig,
    Blocks,
    Precision,
    TrainBlocks,
)
from .registry import ModelSpec, get_model

__all__ = ["BertConfig", "Blocks", "KERNEL_BLOCKS", "ModelSpec", "PLAIN_BLOCKS", "Precision", "TRAIN_KERNEL_BLOCKS",
           "TRAIN_PLAIN_BLOCKS", "TrainBlocks", "get_model"]
