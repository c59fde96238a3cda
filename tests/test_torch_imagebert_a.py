"""The port's ImageBERT-A against the JAX package's, on the same numpy params
and batch: the label-mix quirk alone, and the whole model at the tiny test
config and at the full 12x768 width. f32 scores agree to <= 1e-4, inside
BASELINE.md's 1e-3 per-pair budget; the bf16 CPU path, which rounds where
the JAX bf16 path rounds, is held to a band of 2e-3 on the scores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import Precision as JaxPrecision
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import get_model as jax_get_model
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import imagebert_a as jax_a
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import (
    cast_matmul_weights,
    params_from_jax,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import PLAIN_BLOCKS, Precision, get_model
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import imagebert_a
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.attention import attention_backend
from torch_parity import TINY, imagebert_a_batch, jax_imagebert_a_params


def test_label_mix_matches_jax():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((50, 768)).astype(np.float32)
    mix = rng.standard_normal((8, 1)).astype(np.float32)
    ids = rng.integers(0, 50, (3, 10, 8)).astype(np.int32)
    want = np.asarray(jax_a._label_mix(jnp.asarray(table), jnp.asarray(mix), jnp.asarray(ids)))
    got = imagebert_a._label_mix(torch.from_numpy(table), torch.from_numpy(mix), torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # the quirk itself: dims g*8..g*8+7 of ONE token mix into output dim t*96+g
    e = table[ids[1, 2, 5]]
    assert np.isclose(got[1, 2, 5 * 96 + 7].item(), float(e[56:64] @ mix[:, 0]), atol=1e-6)


def _jax_scores(cfg, tree, batch, prec):
    apply = jax.jit(lambda p, b: jax_a.apply(p, b, cfg, prec)["score"])
    return np.asarray(apply(jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()}))


def _port_scores(cfg, tree, batch, prec):
    params = cast_matmul_weights(params_from_jax(tree), prec.compute_dtype, imagebert_a.MATMUL_KERNELS)
    batch_t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.inference_mode(), attention_backend("pallas_packed"):  # the blocks' route
        return imagebert_a.score(params, batch_t, cfg, prec).numpy(), imagebert_a.score(
            params, batch_t, cfg, prec, PLAIN_BLOCKS
        ).numpy()


@pytest.mark.parametrize(
    "overrides,b",
    [(TINY, 5), ({}, 2)],
    ids=["tiny", "full_12x768"],
)
def test_apply_f32_matches_jax(overrides, b):
    cfg = jax_get_model("imagebert_a", overrides=overrides).config
    tree = jax_imagebert_a_params(cfg, seed=1)
    batch = imagebert_a_batch(b, cfg.vocab_size, seed=2)
    want = _jax_scores(cfg, tree, batch, JaxPrecision.f32())
    port_cfg = get_model("imagebert_a", overrides=overrides).config
    got, got_plain = _port_scores(port_cfg, tree, batch, Precision.f32())
    assert got.shape == (b,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_plain, want, atol=1e-4, rtol=0)


def test_apply_bf16_cpu_path_tracks_jax_bf16():
    cfg = jax_get_model("imagebert_a", overrides=TINY).config
    tree = jax_imagebert_a_params(cfg, seed=3)
    batch = imagebert_a_batch(6, cfg.vocab_size, seed=4)
    want = _jax_scores(cfg, tree, batch, JaxPrecision.bf16())
    got, _ = _port_scores(get_model("imagebert_a", overrides=TINY).config, tree, batch, Precision.bf16())
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


def test_registry(monkeypatch):
    monkeypatch.setenv("KMR_CONFIG_OVERRIDES", '{"hidden_size": 32, "num_hidden_layers": 2}')
    monkeypatch.delenv("KMR_TOWER_CONFIG_OVERRIDES", raising=False)
    spec = get_model("imagebert_a")
    assert (spec.config.hidden_size, spec.config.num_hidden_layers) == (32, 2)
    assert get_model("imagebert_a", overrides={"num_hidden_layers": 1}).config.num_hidden_layers == 1
    assert [get_model(name).sen2forest for name in ("imagebert_a", "imagebert_b", "imagebert_c")] == [
        False, False, True]
    tower = get_model("two_tower")  # the recall towers score pairs on ImageBERT-B's layout
    assert (tower.featurizer_layout, tower.config.bert.num_hidden_layers, tower.config.embed_dim) == (
        "imagebert_b", 4, 128)
    with pytest.raises(ValueError, match="unknown model"):
        get_model("no_such_model")


def test_random_init_is_seeded_and_scores():
    spec = get_model("imagebert_a", overrides=TINY)
    p0, p1 = spec.init_params(7), spec.init_params(7)
    torch.testing.assert_close(p0["featureemb"]["kernel"], p1["featureemb"]["kernel"], rtol=0, atol=0)
    batch = {k: torch.from_numpy(v) for k, v in imagebert_a_batch(4, spec.config.vocab_size, 8).items()}
    s = spec.apply(p0, batch, spec.config, Precision.f32())["score"]
    assert s.shape == (4,) and torch.isfinite(s).all() and ((s > 0) & (s < 1)).all()
