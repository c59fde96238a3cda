"""One reader for every checkpoint format a scorer, a trainer or a teacher
takes, the port of the JAX package's ``scripts/score.py`` :43-82
``load_params``, format by format:

* ``*.npz`` holding a param tree (the JAX package's ``save_npz``, the port's
  ``step_<N>.npz``, ``best.npz``, ``student_final.npz``): the tree itself;
* ``*.npz`` holding a flat variable dict (TF names with ``/``, or torch
  names): the model's importer over it;
* ``*.pth`` / ``*.pt`` / ``*.bin``: a torch state dict, LXMERT's importer;
* a directory: an orbax param tree of the JAX package (``step_<N>``,
  ``best``, ``student_final``), read without orbax (``orbax_io.py``);
* anything else: a TF1 bundle prefix (``<prefix>.index`` beside it), the
  ImageBERT-A importer, or for B/C the importer of the EMA shadows.

The two-tower model has no reference checkpoint: it reads param trees only,
an npz or an orbax directory, as the JAX package's ``scripts/recall.py``
(:61-63) does.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from ..models.core import Params
from .importers import imagebert_a_from_tf, imagebert_b_from_tf, lxmert_from_torch
from .npz import params_from_jax, unflatten_tree
from .orbax_io import restore_pytree
from .tf_bundle import read_tf_checkpoint
from .torch_io import read_torch_state_dict

TORCH_SUFFIXES = (".pth", ".pt", ".bin")


def _is_param_tree(flat: dict) -> bool:
    """An npz's keys that make a param tree: a ``bert/`` subtree whose encoder
    is scan-stacked, not TF's per-layer ``bert/encoder/layer_<i>`` scopes. (The
    JAX package takes any npz with a ``bert`` key for a tree, so a flat
    TF-variable npz fails there, ROADMAP.md Queue 3, JAX fault 7.)"""
    return (any(k.split("/", 1)[0] == "bert" for k in flat)
            and not any(k.startswith("bert/encoder/layer_") for k in flat))


def read_checkpoint(model_name: str, path, spec) -> dict:
    """``path`` -> the param tree in the JAX package's layout (numpy leaves).
    ``spec.config`` gives the importers their depths."""
    p = Path(path)
    if p.is_dir():
        tree = restore_pytree(p)
        if not isinstance(tree, dict) or "bert" not in tree:
            raise ValueError(f"{path}: an orbax tree with no param tree at its root (keys "
                             f"{sorted(tree) if isinstance(tree, dict) else type(tree).__name__}): a "
                             "training state (state_<N>) holds its params under 'params'; pass step_<N>")
        return tree
    if p.suffix == ".npz":
        with np.load(p) as data:
            flat = {k: data[k] for k in data.files}
        if _is_param_tree(flat):
            return unflatten_tree(flat)
    if model_name == "two_tower":
        raise ValueError(f"{path}: a two_tower checkpoint is an npz param tree (the JAX package's save_npz, "
                         "the port's step_<N>.npz) or an orbax directory (the JAX package's step_<N>); the "
                         "reference has no tower checkpoint to import")
    if p.suffix in TORCH_SUFFIXES:
        return lxmert_from_torch(read_torch_state_dict(p), spec.config)
    if p.suffix != ".npz":
        flat = read_tf_checkpoint(p)
    if model_name == "imagebert_a":
        return imagebert_a_from_tf(flat, spec.config)
    if model_name in ("imagebert_b", "imagebert_c"):
        return imagebert_b_from_tf(flat, spec.config, ema=True)
    return lxmert_from_torch(flat, spec.config)


def load_checkpoint(model_name: str, path, spec) -> Params:
    """``path`` (any format of ``read_checkpoint``; ``None`` = the spec's random
    init from seed 0) -> the port's float32 params, as an npz tree is taken:
    ``spec.from_jax(params_from_jax(tree))``."""
    if path is None:
        print("WARNING: no checkpoint given; using random init (seed 0)", file=sys.stderr)
        return spec.init_params(0)
    return spec.from_jax(params_from_jax(read_checkpoint(model_name, path, spec)))
