from .npz import (
    cast_matmul_weights,
    flatten_tree,
    load_npz,
    params_from_jax,
    params_to_jax,
    save_npz,
    scoring_params,
    tree_to,
    unflatten_tree,
)

__all__ = [
    "cast_matmul_weights",
    "flatten_tree",
    "load_npz",
    "params_from_jax",
    "params_to_jax",
    "save_npz",
    "scoring_params",
    "tree_to",
    "unflatten_tree",
]
