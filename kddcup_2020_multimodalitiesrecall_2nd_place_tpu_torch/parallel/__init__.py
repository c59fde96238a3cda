from .engine import (
    ScoringEngine,
    ScoringStats,
    default_attention_backend,
    resolve_device,
    write_scores_csv,
    write_scores_tsv,
)

__all__ = ["ScoringEngine", "ScoringStats", "default_attention_backend", "resolve_device",
           "write_scores_csv", "write_scores_tsv"]
