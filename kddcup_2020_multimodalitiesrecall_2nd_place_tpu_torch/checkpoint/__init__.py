from .formats import load_checkpoint, read_checkpoint
from .importers import (
    MissingVariable,
    imagebert_a_from_tf,
    imagebert_b_from_tf,
    lxmert_from_torch,
    normalize_torch_keys,
)
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
from .tf_bundle import read_tf_checkpoint
from .torch_io import read_torch_state_dict

__all__ = [
    "MissingVariable",
    "cast_matmul_weights",
    "flatten_tree",
    "imagebert_a_from_tf",
    "imagebert_b_from_tf",
    "load_checkpoint",
    "load_npz",
    "lxmert_from_torch",
    "normalize_torch_keys",
    "params_from_jax",
    "params_to_jax",
    "read_checkpoint",
    "read_tf_checkpoint",
    "read_torch_state_dict",
    "save_npz",
    "scoring_params",
    "tree_to",
    "unflatten_tree",
]
