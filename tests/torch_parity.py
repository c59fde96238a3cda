"""Shared pieces of the PyTorch-port parity tests (``tests/test_torch_*.py``).

Inputs and parameters are made with numpy from a seed and handed, as the
same arrays, to the JAX package and to the port.
"""

from __future__ import annotations

import numpy as np
import pytest

JAX_PKG = "kddcup_2020_multimodalitiesrecall_2nd_place_tpu"
TORCH_PKG = "kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch"

# the tiny config of tests/test_end_to_end.py
TINY = {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 37}


@pytest.fixture
def cuda():
    """The CUDA device, or a skip where there is none (decided at run time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def numpy_like(shapes, seed: int):
    """A tree of numpy float32 arrays with the shapes of ``shapes`` (a tree
    of objects with ``.shape``): LayerNorm gammas near 1, everything else
    small and non-zero, so biases and LayerNorm affine terms are exercised."""
    rng = np.random.default_rng(seed)

    def fill(tree, name=""):
        if isinstance(tree, dict):
            return {k: fill(v, k) for k, v in tree.items()}
        noise = rng.standard_normal(tree.shape).astype(np.float32)
        if name == "gamma":
            return (1.0 + 0.1 * noise).astype(np.float32)
        return (0.02 * noise).astype(np.float32)

    return fill(shapes)


def jax_imagebert_a_params(cfg, seed: int):
    """Numpy params in the JAX ImageBERT-A tree layout for ``cfg``."""
    import jax

    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import imagebert_a

    shapes = jax.eval_shape(lambda: imagebert_a.init_params(jax.random.key(0), cfg))
    return numpy_like(shapes, seed)


def jax_imagebert_b_params(cfg, seed: int):
    """Numpy params in the JAX ImageBERT-B/C tree layout for ``cfg``."""
    import jax

    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import imagebert_b

    shapes = jax.eval_shape(lambda: imagebert_b.init_params(jax.random.key(0), cfg))
    return numpy_like(shapes, seed)


def imagebert_b_batch(b: int, vocab_size: int, seed: int, label: int = 1) -> dict[str, np.ndarray]:
    """An ImageBERT-B/C batch: query lengths 2..20, box counts 0..10 (pair 0
    with no box, so all its image keys are masked), the fed label."""
    rng = np.random.default_rng(seed)
    num_boxes = rng.integers(0, 11, (b,)).astype(np.int32)
    num_boxes[0] = 0
    return {
        "input_ids": rng.integers(0, vocab_size, (b, 20)).astype(np.int32),
        "len_query": rng.integers(2, 21, (b,)).astype(np.int32),
        "num_boxes": num_boxes,
        "segment_ids": np.tile(np.array([0] * 20 + [1] * 10, dtype=np.int32), (b, 1)),
        "boxes": rng.random((b, 10, 5)).astype(np.float32),
        "features": rng.standard_normal((b, 10, 2048)).astype(np.float32),
        "label_ids": rng.integers(0, vocab_size, (b, 10, 8)).astype(np.int32),
        "labels": np.full((b,), label, dtype=np.int32),
    }


def imagebert_a_batch(b: int, vocab_size: int, seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "input_ids": rng.integers(0, vocab_size, (b, 20)).astype(np.int32),
        "segment_ids": rng.integers(0, 2, (b, 20)).astype(np.int32),
        "features": rng.standard_normal((b, 10, 2048)).astype(np.float32),
        "label_ids": rng.integers(0, vocab_size, (b, 10, 8)).astype(np.int32),
    }


def weights(rng, shapes):
    """Block weights: LayerNorm gammas near 1, vectors at 0.05 scale, and
    matrices at 0.8/sqrt(fan_in), so activations keep unit scale at any width."""
    out = []
    for name, shape in shapes:
        noise = rng.standard_normal(shape).astype(np.float32)
        if name == "gamma":
            out.append(1.0 + 0.1 * noise)
        else:
            out.append((0.8 / np.sqrt(shape[0]) if name.startswith("w") else 0.05) * noise)
    return [a.astype(np.float32) for a in out]


def attn_inputs(seed, b=3, s=40, h=64, with_bias=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h)).astype(np.float32)
    ws = weights(rng, [("wqkv", (h, 3 * h)), ("bqkv", (3 * h,)), ("wo", (h, h)), ("bo", (h,)),
                        ("gamma", (h,)), ("beta", (h,))])
    mask = None
    if with_bias:
        mask = (rng.random((b, s)) > 0.3).astype(np.float32)
        mask[:, 0] = 1.0  # at least one live key per row
    return x, ws, mask


def layer_inputs(seed, b=3, s=40, h=64, i=128, with_bias=False):
    """x, the layer's 12 weights (attention block's, then FFN block's) and a
    key mask [b, s] (None without bias; at least one live key a row)."""
    x, aw, mask = attn_inputs(seed, b, s, h, with_bias)
    _, fw = ffn_inputs(seed + 1000, b, s, h, i)
    return x, aw + fw, mask


def ffn_inputs(seed, b=3, s=40, h=64, i=128):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h)).astype(np.float32)
    ws = weights(rng, [("w1", (h, i)), ("b1", (i,)), ("w2", (i, h)), ("b2", (h,)),
                        ("gamma", (h,)), ("beta", (h,))])
    return x, ws
