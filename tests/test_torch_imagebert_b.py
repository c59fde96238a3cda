"""The port's ImageBERT-B/C against the JAX package's, on the same numpy
params and batches: the featurizer layout (B, and C with the sen2forest
rewrite), the banded label conv, the AM head around its 0.35 margin, and the
whole model at the tiny test config and at the full 12x768 width. The port
runs the encoder at S=30, the JAX package at its padded S=32 (two masked
keys, softmax weight exactly 0 in f32). f32 scores agree to <= 1e-4, inside
BASELINE.md's 1e-3 per-pair budget; the bf16 CPU path, which rounds where
the JAX bf16 path rounds, is held to 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu import data as jax_data
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import Precision as JaxPrecision
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import get_model as jax_get_model
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import heads as jax_heads
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import imagebert_b as jax_b
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.tokenization import FullTokenizer as JaxTokenizer
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch import VOCAB_PATH, data
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import cast_matmul_weights, params_from_jax
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import synthetic
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.tsv import SEN2FOREST_SRC, is_header, parse_line
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import PLAIN_BLOCKS, Precision, get_model, heads
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import imagebert_b
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.attention import attention_backend
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.tokenization import FullTokenizer
from torch_parity import TINY, imagebert_b_batch, jax_imagebert_b_params


@pytest.mark.parametrize("name", ["imagebert_b", "imagebert_c"])
def test_layout_matches_jax(tmp_path, name):
    """Key for key and value for value, on rows with and without the
    sen2forest trigger; C differs from B only on trigger rows."""
    lines = synthetic.make_tsv(40, seed=11)
    assert any(SEN2FOREST_SRC in line for line in lines)
    tsv = tmp_path / "pairs.tsv"
    tsv.write_text("\n".join(lines) + "\n")
    labels = tmp_path / "labels.txt"
    labels.write_text("".join(f"{k}\t{v}\n" for k, v in synthetic.SYNTHETIC_LABELS.items()))
    c = name == "imagebert_c"
    port_fz = data.Featurizer(FullTokenizer.google_style(VOCAB_PATH), data.load_multimodal_labels(labels),
                              sen2forest=c)
    ref_fz = jax_data.Featurizer(JaxTokenizer.google_style(VOCAB_PATH), jax_data.load_multimodal_labels(labels),
                                 sen2forest=c)
    got = list(data.batches_from_files([tsv], port_fz.for_model(name), 16))
    want = list(jax_data.batches_from_files([tsv], ref_fz.for_model(name), 16))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    b_fz = data.Featurizer(port_fz.tokenizer, port_fz.label_texts)
    for line in (line for line in lines if not is_header(line)):
        ex = parse_line(line)
        same = np.array_equal(port_fz.for_model(name)(ex)["input_ids"], b_fz.imagebert_b(ex)["input_ids"])
        assert same == (not c or SEN2FOREST_SRC not in ex.query)


def test_label_conv_matches_jax():
    """The banded product equals JAX's, and both equal the shifted-tap conv
    computed directly in numpy (SAME padding: 3 left, 4 right)."""
    rng = np.random.default_rng(0)
    h = 16
    w = rng.standard_normal((8, h, h)).astype(np.float32)
    bias = rng.standard_normal((h,)).astype(np.float32)
    emb = rng.standard_normal((3, 10, 8, h)).astype(np.float32)
    want = np.asarray(jax_b._label_conv({"weights": jnp.asarray(w), "biases": jnp.asarray(bias)},
                                        jnp.asarray(emb), JaxPrecision.f32()))
    band = imagebert_b.label_conv_band(torch.from_numpy(w), torch.from_numpy(bias))
    assert band["kernel"].shape == (8 * h, 8 * h) and band["bias"].shape == (8 * h,)
    got = imagebert_b._label_conv(band, torch.from_numpy(emb), Precision.f32())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    pad = np.pad(emb, ((0, 0), (0, 0), (3, 4), (0, 0)))
    direct = np.stack([sum(pad[:, :, o + k] @ w[k] for k in range(8)) for o in range(8)], axis=2) + bias
    np.testing.assert_allclose(got.numpy(), np.maximum(direct, 0).mean(axis=2), atol=1e-4, rtol=0)
    # the plain product, as PLAIN_BLOCKS runs it, is the same function
    plain = imagebert_b._label_conv(band, torch.from_numpy(emb), Precision.f32(), PLAIN_BLOCKS)
    assert torch.equal(plain, got)


@pytest.mark.parametrize("label", [0, 1])
def test_am_head_matches_jax(label):
    """Crafted cosines on both sides of the 0.35 margin, in either class: the
    margin lands on the fed label's class, only where its cos > 0.35."""
    cos = np.array([[0.36, 0.2], [0.34, 0.5], [0.5, 0.349], [0.1, 0.351], [-0.4, 0.9], [0.351, 0.349]])
    rest = np.sqrt(1.0 - (cos**2).sum(axis=1, keepdims=True))
    pooled = np.concatenate([cos, rest, np.zeros((len(cos), 5))], axis=1).astype(np.float32) * 3.0
    kernel = np.zeros((8, 2), np.float32)
    kernel[0, 0], kernel[1, 1] = 2.0, 0.5  # any positive scale: columns are normalised
    labels = np.full((len(cos),), label, np.int32)
    want = np.asarray(jax_heads.am_probs({"am_kernel": jnp.asarray(kernel)}, jnp.asarray(pooled), jnp.asarray(labels)))
    p = {"am_kernel": torch.from_numpy(kernel)}
    got = heads.am_probs(p, torch.from_numpy(pooled), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    got_cos = heads.am_cosines(p, torch.from_numpy(pooled)).numpy()
    np.testing.assert_allclose(got_cos, cos, atol=1e-6)
    logits = heads.am_margin_logits(torch.from_numpy(got_cos), torch.from_numpy(labels)).numpy()
    shift = got_cos * heads.AM_SCALE - logits  # scale * margin on the label's class, or nothing
    want_shift = np.zeros_like(shift)
    want_shift[:, label] = np.where(cos[:, label] > heads.AM_MARGIN, heads.AM_MARGIN * heads.AM_SCALE, 0.0)
    np.testing.assert_allclose(shift, want_shift, atol=1e-5)


def _jax_scores(cfg, tree, batch, prec):
    apply = jax.jit(lambda p, b: jax_b.apply(p, b, cfg, prec)["score"])
    return np.asarray(apply(jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()}))


def _port_scores(cfg, tree, batch, prec):
    params = cast_matmul_weights(imagebert_b.from_jax(params_from_jax(tree)), prec.compute_dtype,
                                 imagebert_b.MATMUL_KERNELS)
    batch_t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.inference_mode(), attention_backend("pallas_packed"):  # the blocks' route
        return (imagebert_b.score(params, batch_t, cfg, prec).numpy(),
                imagebert_b.score(params, batch_t, cfg, prec, PLAIN_BLOCKS).numpy())


@pytest.mark.parametrize("overrides,b", [(TINY, 5), ({}, 2)], ids=["tiny", "full_12x768"])
def test_apply_f32_matches_jax(overrides, b):
    cfg = jax_get_model("imagebert_b", overrides=overrides).config
    tree = jax_imagebert_b_params(cfg, seed=1)
    batch = imagebert_b_batch(b, cfg.vocab_size, seed=2)
    want = _jax_scores(cfg, tree, batch, JaxPrecision.f32())
    got, got_plain = _port_scores(get_model("imagebert_b", overrides=overrides).config, tree, batch, Precision.f32())
    assert got.shape == (b,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_plain, want, atol=1e-4, rtol=0)


def test_fused_route_scores_match_jax(monkeypatch):
    """KMR_FUSED_LAYER=1 on both sides: the port's fused encoder layers
    against the JAX package's, which falls back to its two blocks on the CPU
    (no packed inference backend there), so this also holds the fused route to
    the two-block one."""
    cfg = jax_get_model("imagebert_b", overrides=TINY).config
    tree = jax_imagebert_b_params(cfg, seed=9)
    batch = imagebert_b_batch(5, cfg.vocab_size, seed=10)
    monkeypatch.setenv("KMR_FUSED_LAYER", "1")
    want = _jax_scores(cfg, tree, batch, JaxPrecision.f32())
    got, got_plain = _port_scores(get_model("imagebert_b", overrides=TINY).config, tree, batch, Precision.f32())
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_plain, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("label", [0, 1])
def test_apply_bf16_cpu_path_tracks_jax_bf16(label):
    cfg = jax_get_model("imagebert_b", overrides=TINY).config
    tree = jax_imagebert_b_params(cfg, seed=3)
    batch = imagebert_b_batch(6, cfg.vocab_size, seed=4, label=label)
    want = _jax_scores(cfg, tree, batch, JaxPrecision.bf16())
    got, _ = _port_scores(get_model("imagebert_b", overrides=TINY).config, tree, batch, Precision.bf16())
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


def test_params_from_jax_b_tree():
    cfg = jax_get_model("imagebert_b", overrides=TINY).config
    tree = jax_imagebert_b_params(cfg, seed=5)
    tree["cls"]["predictions"] = {"output_bias": np.zeros(3, np.float32)}  # an MLM head: dropped
    h = cfg.hidden_size
    loaded = params_from_jax(tree)
    assert loaded["kdd_conv1"].keys() == {"weights", "biases"}  # the loader leaves the taps to the model
    params = get_model("imagebert_b", overrides=TINY).from_jax(loaded)
    assert params["cls"].keys() == {"seq_relationship"}
    conv = params["kdd_conv1"]
    assert conv.keys() == {"kernel", "bias"} and conv["kernel"].shape == (8 * h, 8 * h)
    want = imagebert_b.label_conv_band(torch.from_numpy(tree["kdd_conv1"]["weights"]),
                                       torch.from_numpy(tree["kdd_conv1"]["biases"]))
    assert torch.equal(conv["kernel"], want["kernel"]) and torch.equal(conv["bias"], want["bias"])
    att = params["bert"]["encoder"]["attention"]
    assert att["qkv"]["kernel"].shape == (cfg.num_hidden_layers, h, 3 * h) and "query" not in att
    cast = cast_matmul_weights(params, torch.bfloat16, imagebert_b.MATMUL_KERNELS)
    assert cast["kdd_conv1"]["kernel"].dtype == torch.bfloat16 and cast["kdd_conv1"]["bias"].dtype == torch.float32
    assert cast["cls"]["seq_relationship"]["am_kernel"].dtype == torch.float32


def test_registry_b_and_c():
    b, c = get_model("imagebert_b", overrides=TINY), get_model("imagebert_c", overrides=TINY)
    assert (b.sen2forest, c.sen2forest) == (False, True)
    assert b.featurizer_layout == c.featurizer_layout == "imagebert_b"
    p0, p1 = b.init_params(7), c.init_params(7)
    torch.testing.assert_close(p0["kdd_conv1"]["kernel"], p1["kdd_conv1"]["kernel"], rtol=0, atol=0)
    batch = {k: torch.from_numpy(v) for k, v in imagebert_b_batch(4, b.config.vocab_size, 8).items()}
    assert set(batch) == set(imagebert_b.INPUT_KEYS)
    s = b.apply(p0, batch, b.config, Precision.f32())["score"]
    assert s.shape == (4,) and torch.isfinite(s).all() and ((s > 0) & (s < 1)).all()
