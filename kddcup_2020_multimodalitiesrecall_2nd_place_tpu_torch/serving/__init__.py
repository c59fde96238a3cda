from .export import ServingScorer, export_scorer, export_tower, load_scorer, save_scorer

__all__ = ["ServingScorer", "export_scorer", "export_tower", "load_scorer", "save_scorer"]
