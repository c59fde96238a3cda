from .ndcg import dcg_at_k, evaluate_scores, evaluate_submission, load_answers, ndcg_at_k

__all__ = [
    "dcg_at_k",
    "evaluate_scores",
    "evaluate_submission",
    "load_answers",
    "ndcg_at_k",
]
