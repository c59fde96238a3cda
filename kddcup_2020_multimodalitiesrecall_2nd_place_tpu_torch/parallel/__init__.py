from .engine import (
    ScoringEngine,
    ScoringStats,
    default_attention_backend,
    load_tsv_scores,
    resolve_device,
    write_scores_csv,
    write_scores_tsv,
)

__all__ = ["ScoringEngine", "ScoringStats", "default_attention_backend", "load_tsv_scores", "resolve_device",
           "write_scores_csv", "write_scores_tsv"]
