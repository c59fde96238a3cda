from .engine import ScoringEngine, ScoringStats, resolve_device, write_scores_csv, write_scores_tsv

__all__ = ["ScoringEngine", "ScoringStats", "resolve_device", "write_scores_csv", "write_scores_tsv"]
