"""Score fusion and the product-dedup rerank into the top-5 submission:
``fusion.py`` on the host (dicts, no torch, so the fusion CLI starts fast);
``vectorized.py``, imported on its own, the same on a device (tensors)."""

from .fusion import (
    DEFAULT_WEIGHTS,
    FusionResult,
    build_submission,
    dedup_filter,
    fuse,
    load_csv_scores,
    load_tsv_scores,
    read_submission,
    single_model_fusion,
    single_model_top5,
    top5_rows,
    write_submission,
)

__all__ = [
    "DEFAULT_WEIGHTS",
    "FusionResult",
    "build_submission",
    "dedup_filter",
    "fuse",
    "load_csv_scores",
    "load_tsv_scores",
    "read_submission",
    "single_model_fusion",
    "single_model_top5",
    "top5_rows",
    "write_submission",
]
