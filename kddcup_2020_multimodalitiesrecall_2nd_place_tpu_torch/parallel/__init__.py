from .engine import (
    ScoringEngine,
    ScoringStats,
    TowerEngine,
    default_attention_backend,
    resolve_device,
    write_scores_csv,
    write_scores_tsv,
)

__all__ = ["ScoringEngine", "ScoringStats", "TowerEngine", "default_attention_backend", "resolve_device",
           "write_scores_csv", "write_scores_tsv"]
