from .core import KERNEL_BLOCKS, PLAIN_BLOCKS, BertConfig, Blocks, Precision
from .registry import ModelSpec, get_model

__all__ = ["BertConfig", "Blocks", "KERNEL_BLOCKS", "ModelSpec", "PLAIN_BLOCKS", "Precision", "get_model"]
