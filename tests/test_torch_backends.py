"""The port's scorers under each attention backend ("xla", "pallas",
"pallas_packed") against the JAX package's ``apply`` under the same backend,
on the same numpy params and batch, in f32: through ``ScoringEngine``'s
``attention_backend``. JAX's Pallas kernels target a TPU, so the test runs
them in interpret mode by patching the module attributes that its
``ops/attention.py`` and ``models/core.py`` import at call time (no JAX file
changes). At full 12x768 the port's "xla" and "pallas" routes are held to
JAX's "xla". Tolerance: 1e-4 on each score (``BASELINE.md``'s per-pair budget
is 1e-3) and the same nDCG@5. Also: the engine's default-backend rule, and
LXMERT, whose cross attention the "pallas" backend cannot run in either
package.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import Precision as JaxPrecision
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import get_model as jax_get_model
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import imagebert_a as jax_a
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import imagebert_b as jax_b
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import lxmert as jax_lxmert
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.ops import attention as jax_attention
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.ops import pallas_attention, pallas_ffn
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import params_from_jax
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.batchspec import example_batch
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.eval import evaluate_scores
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import Precision, get_model
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.parallel import ScoringEngine, default_attention_backend
from torch_parity import (
    TINY,
    imagebert_a_batch,
    imagebert_b_batch,
    jax_imagebert_a_params,
    jax_imagebert_b_params,
    numpy_like,
)

BACKENDS = ["xla", "pallas", "pallas_packed"]
MODELS = {"imagebert_a": (jax_a, jax_imagebert_a_params, imagebert_a_batch),
          "imagebert_b": (jax_b, jax_imagebert_b_params, imagebert_b_batch)}
B = 8  # two queries of four pairs each (_ndcg)


@pytest.fixture
def jax_interpret(monkeypatch):
    """JAX's kernels of the "pallas" and "pallas_packed" backends in interpret mode."""
    for mod, name in ((pallas_attention, "mha_pallas"), (pallas_attention, "attention_block_pallas"),
                      (pallas_ffn, "ffn_block_pallas")):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), interpret=True))


def _jax_scores(jmod, cfg, tree, batch, backend):
    with jax_attention.attention_backend(backend):  # read while jit traces
        apply = jax.jit(lambda p, b: jmod.apply(p, b, cfg, JaxPrecision.f32())["score"])
        return np.asarray(apply(jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()}))


def _port_scores(name, overrides, tree, batch, backend):
    spec = get_model(name, overrides=overrides)
    engine = ScoringEngine(spec, spec.from_jax(params_from_jax(tree)), device="cpu", precision=Precision.f32(),
                           attention_backend=backend)
    assert engine.attention_backend == backend
    return engine.score_batch(batch).numpy()


def _ndcg(scores) -> float:
    """nDCG@5 of pairs 0-3 (query 0, answers 0 and 2) and 4-7 (query 1, answer 5)."""
    table = {str(i // 4): {} for i in range(B)}
    for i, s in enumerate(scores):
        table[str(i // 4)][str(i)] = float(s)
    return evaluate_scores(table, {"0": ["0", "2"], "1": ["5"]})


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", list(MODELS))
def test_backend_matches_jax_tiny(name, backend, jax_interpret):
    jmod, make_params, make_batch = MODELS[name]
    cfg = jax_get_model(name, overrides=TINY).config
    tree = make_params(cfg, seed=11)
    batch = make_batch(B, cfg.vocab_size, seed=12)
    want = _jax_scores(jmod, cfg, tree, batch, backend)
    got = _port_scores(name, TINY, tree, batch, backend)
    assert got.shape == (B,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert _ndcg(got) == _ndcg(want)


@functools.lru_cache(maxsize=None)
def _full_width(name):
    """The full 12x768 params, a batch, and JAX's f32 "xla" scores."""
    jmod, make_params, make_batch = MODELS[name]
    cfg = jax_get_model(name).config
    tree = make_params(cfg, seed=13)
    batch = make_batch(B, cfg.vocab_size, seed=14)
    return tree, batch, _jax_scores(jmod, cfg, tree, batch, "xla")


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("name", list(MODELS))
def test_backend_matches_jax_full_width(name, backend):
    tree, batch, want = _full_width(name)
    got = _port_scores(name, {}, tree, batch, backend)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert _ndcg(got) == _ndcg(want)


def test_default_backend_rule():
    """The JAX engine's rule as a pure function of device and precision:
    "pallas_packed" on CUDA in bf16, "xla" in f32 or on the CPU; an explicit
    name is validated and kept."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert default_attention_backend(cuda, Precision.bf16()) == "pallas_packed"
    assert default_attention_backend(cuda, Precision.f32()) == "xla"
    assert default_attention_backend(cpu, Precision.bf16()) == "xla"
    assert default_attention_backend(cpu, Precision.f32()) == "xla"
    spec = get_model("imagebert_a", overrides=TINY)
    params = spec.init_params(0)
    assert ScoringEngine(spec, params, device="cpu").attention_backend == "xla"
    for name in BACKENDS:
        assert ScoringEngine(spec, params, device="cpu", attention_backend=name).attention_backend == name
    with pytest.raises(ValueError, match="unknown attention backend"):
        ScoringEngine(spec, params, device="cpu", attention_backend="packed")


def test_lxmert_xla_matches_jax_and_pallas_raises(jax_interpret):
    """LXMERT (tiny, 2/2/1 layers) on "xla" matches JAX's; on "pallas" both
    packages fail at the first x-layer, whose cross attention (23 <- 10)
    mha_pallas cannot reshape."""
    depths = {"l_layers": 2, "x_layers": 2, "r_layers": 1}
    lcfg = jax_get_model("lxmert", overrides={**TINY, **depths}).config
    tree = numpy_like(jax.eval_shape(lambda: jax_lxmert.init_params(jax.random.key(0), lcfg)), seed=15)
    batch = example_batch("lxmert", lcfg, 4, np.random.default_rng(16))
    want = _jax_scores(jax_lxmert, lcfg, tree, batch, "xla")
    np.testing.assert_allclose(_port_scores("lxmert", {**TINY, **depths}, tree, batch, "xla"), want, atol=1e-4, rtol=0)
    with pytest.raises(TypeError, match="cannot reshape"):
        _jax_scores(jax_lxmert, lcfg, tree, batch, "pallas")
    with pytest.raises(ValueError, match="self-attention only"):
        _port_scores("lxmert", {**TINY, **depths}, tree, batch, "pallas")
