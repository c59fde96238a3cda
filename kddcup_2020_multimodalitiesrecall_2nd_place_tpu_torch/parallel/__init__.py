from .distributed import (
    global_batch_from_local,
    local_rows,
    maybe_initialize,
    process_count,
    process_index,
    process_shard,
    stride_lines,
)
from .engine import (
    ScoringEngine,
    ScoringStats,
    TowerEngine,
    default_attention_backend,
    resolve_device,
    write_scores_csv,
    write_scores_tsv,
)

from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, batch_sharding, data_parallel_batch_size, make_mesh, replicated, shard_batch

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "ScoringEngine", "ScoringStats", "TowerEngine", "batch_sharding",
           "data_parallel_batch_size", "default_attention_backend", "global_batch_from_local", "local_rows",
           "make_mesh", "maybe_initialize", "process_count", "process_index", "process_shard", "replicated",
           "resolve_device", "shard_batch", "stride_lines", "write_scores_csv", "write_scores_tsv"]
