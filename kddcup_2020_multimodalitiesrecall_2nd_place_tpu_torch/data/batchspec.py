"""Scoring-batch layouts per model (the port of the JAX package's
``data/batchspec.py``): the feature arrays each model's ``apply`` consumes,
with their trailing shapes and dtypes, as ``featurize.Featurizer`` emits them
from a TSV row (reference row formats in
``imagebert_lds/src/load_data_pred.py:94-121`` and
``lxmert/src/tasks/kdd_data.py:88-108``). The serving export traces against
these; a model reads a subset of them (its spec's ``input_keys``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["batch_spec", "example_batch"]


def example_batch(name: str, cfg, B: int, rng) -> dict[str, np.ndarray]:
    """Random numpy feature batch with the exact scoring layout of ``name``
    (meta keys like product_id/query_id/valid excluded); the JAX package's
    ``example_batch``, draw for draw."""
    if name in ("imagebert_a", "imagebert_b", "imagebert_c"):
        b = {
            "input_ids": rng.integers(0, cfg.vocab_size, (B, 20)).astype(np.int32),
            "segment_ids": (
                np.zeros((B, 20), np.int32)
                if name == "imagebert_a"
                else np.array([[0] * 20 + [1] * 10] * B, np.int32)
            ),
            "boxes": rng.standard_normal((B, 10, 5)).astype(np.float32),
            "features": rng.standard_normal((B, 10, 2048)).astype(np.float32),
            "label_ids": rng.integers(0, cfg.vocab_size, (B, 10, 8)).astype(np.int32),
        }
        if name != "imagebert_a":
            b["len_query"] = rng.integers(3, 21, (B,)).astype(np.int32)
            b["num_boxes"] = rng.integers(1, 11, (B,)).astype(np.int32)
            b["labels"] = np.ones((B,), np.int32)
        return b
    if name == "lxmert":
        nb = rng.integers(1, 11, (B,))
        nq = rng.integers(3, 24, (B,))
        v = cfg.bert.vocab_size
        return {
            "input_ids": rng.integers(0, v, (B, 23)).astype(np.int32),
            "input_mask": (np.arange(23)[None] < nq[:, None]).astype(np.int32),
            "label_ids": rng.integers(0, v, (B, 10, 8)).astype(np.int32),
            "label_mask": np.ones((B, 10, 8), np.int32),
            "boxes": rng.standard_normal((B, 10, 4)).astype(np.float32),
            "features": rng.standard_normal((B, 10, 2048)).astype(np.float32),
            "feats_mask": (np.arange(10)[None] < nb[:, None]).astype(np.float32),
        }
    raise ValueError(f"unknown model {name!r}")


def batch_spec(name: str, cfg, B) -> dict[str, tuple[tuple, np.dtype]]:
    """{key: (shape, dtype)} of :func:`example_batch`, with ``B`` as the
    leading dim: an int, or a symbolic batch (a ``torch.export.Dim``). Read
    from a B=1 example, so no batch of features is drawn to learn a shape."""
    ex = example_batch(name, cfg, 1, np.random.default_rng(0))
    return {k: ((B, *v.shape[1:]), v.dtype) for k, v in ex.items()}
