"""The port's LXMERT against the JAX package's, on the same numpy params
(through ``params_from_jax``) and the same numpy batch with ragged masks:
the whole model at the tiny config of ``tests/test_models_spec.py`` (2/2/2
layers, H=32) and at full width (9/5/5 x 768), the ``KMR_DUAL_CROSS=1``
route, the parameter layout, and the LXMERT featurizer layout.

Budgets: f32 scores within 1e-4 of JAX ``lxmert.apply`` (as
``test_torch_imagebert_a.py``; BASELINE.md's per-pair budget is 1e-3). The
dual route runs the same plain arithmetic on the CPU, within 1e-5. The bf16
CPU path rounds where the JAX bf16 path rounds (embeddings, q/kv/qkv, probs,
ctx, GELU output, each block output), so at the tiny config its scores stay
within ImageBERT-A's band of 2e-3 of JAX's bf16 scores (they agreed to 3e-8
when the band was set): a summation-order difference could still flip one
bf16 rounding, which the x-layers carry into both streams.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu import data as jax_data
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import BertConfig as JaxBertConfig
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import LxmertConfig as JaxLxmertConfig
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import Precision as JaxPrecision
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import get_model as jax_get_model
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import lxmert as jax_lxmert
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.tokenization import FullTokenizer as JaxTokenizer
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch import VOCAB_PATH, data
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import cast_matmul_weights, params_from_jax
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import scoring_params
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import synthetic
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import PLAIN_BLOCKS, BertConfig, Precision, get_model
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.attention import attention_backend
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import imagebert_a, lxmert
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.tokenization import FullTokenizer
from torch_parity import numpy_like

# the tiny config of tests/test_models_spec.py:18-27
TINY_BERT = dict(vocab_size=101, hidden_size=32, num_hidden_layers=3, num_attention_heads=4,
                 intermediate_size=57, max_position_embeddings=64)
TINY_DEPTHS = dict(l_layers=2, x_layers=2, r_layers=2, visual_feat_dim=48, visual_pos_dim=4)
BF16_SCORE_BAND = 2e-3


def _configs(full: bool):
    """(JAX LxmertConfig, port LxmertConfig) of one shape."""
    if full:
        return jax_get_model("lxmert").config, get_model("lxmert").config
    return (JaxLxmertConfig(bert=JaxBertConfig(**TINY_BERT), **TINY_DEPTHS),
            lxmert.LxmertConfig(bert=BertConfig(**TINY_BERT), **TINY_DEPTHS))


def jax_lxmert_params(lcfg, seed: int):
    shapes = jax.eval_shape(lambda: jax_lxmert.init_params(jax.random.key(0), lcfg))
    return numpy_like(shapes, seed)


def lxmert_batch(b: int, lcfg, seed: int) -> dict[str, np.ndarray]:
    """Ragged query lengths (3..23) and box counts (0..10; a pair with no box
    has every visn key masked)."""
    rng = np.random.default_rng(seed)
    vocab = lcfg.bert.vocab_size
    nq = rng.integers(3, 24, (b,))
    nb = rng.integers(0, 11, (b,))
    nb[0] = 0
    return {
        "input_ids": rng.integers(0, vocab, (b, 23)).astype(np.int32),
        "input_mask": (np.arange(23)[None] < nq[:, None]).astype(np.int32),
        "label_ids": rng.integers(0, vocab, (b, 10, 8)).astype(np.int32),
        "boxes": rng.random((b, 10, 4)).astype(np.float32),
        "features": rng.standard_normal((b, 10, lcfg.visual_feat_dim)).astype(np.float32),
        "feats_mask": (np.arange(10)[None] < nb[:, None]).astype(np.float32),
    }


def _jax_scores(lcfg, tree, batch, prec):
    apply = jax.jit(lambda p, bt: jax_lxmert.apply(p, bt, lcfg, prec)["score"])
    return np.asarray(apply(jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()}))


def _port_scores(lcfg, tree, batch, prec, blocks=None):
    params = cast_matmul_weights(params_from_jax(tree), prec.compute_dtype, lxmert.MATMUL_KERNELS)
    batch_t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.inference_mode(), attention_backend("pallas_packed"):  # the blocks' route
        if blocks is None:
            return lxmert.score(params, batch_t, lcfg, prec).numpy()
        return lxmert.score(params, batch_t, lcfg, prec, blocks).numpy()


@pytest.mark.parametrize("full,b", [(False, 5), (True, 2)], ids=["tiny", "full_9_5_5x768"])
def test_apply_f32_matches_jax(full, b):
    jcfg, pcfg = _configs(full)
    tree = jax_lxmert_params(jcfg, seed=1)
    batch = lxmert_batch(b, jcfg, seed=2)
    want = _jax_scores(jcfg, tree, batch, JaxPrecision.f32())
    got = _port_scores(pcfg, tree, batch, Precision.f32())
    got_plain = _port_scores(pcfg, tree, batch, Precision.f32(), PLAIN_BLOCKS)
    assert got.shape == (b,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_plain, want, atol=1e-4, rtol=0)


def test_dual_cross_route_gives_the_same_scores(monkeypatch):
    jcfg, pcfg = _configs(False)
    tree = jax_lxmert_params(jcfg, seed=3)
    batch = lxmert_batch(6, jcfg, seed=4)
    default = _port_scores(pcfg, tree, batch, Precision.f32())
    monkeypatch.setenv("KMR_DUAL_CROSS", "1")
    dual = _port_scores(pcfg, tree, batch, Precision.f32())
    dual_plain = _port_scores(pcfg, tree, batch, Precision.f32(), PLAIN_BLOCKS)
    np.testing.assert_allclose(dual, default, atol=1e-5, rtol=0)
    np.testing.assert_allclose(dual_plain, default, atol=1e-5, rtol=0)


def test_fused_layer_route_matches_jax(monkeypatch):
    """KMR_FUSED_LAYER=1: each x-layer's self-attention + FFN as one fused
    encoder layer, in both streams, the L and R stacks as two blocks; held to
    JAX's scores (its fused layer needs the packed TPU backend, so on the CPU
    it runs the two blocks) and counted through the wrappers."""
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import core

    jcfg, pcfg = _configs(False)
    tree = jax_lxmert_params(jcfg, seed=5)
    batch = lxmert_batch(5, jcfg, seed=6)
    want = _jax_scores(jcfg, tree, batch, JaxPrecision.f32())
    monkeypatch.setenv("KMR_FUSED_LAYER", "1")
    calls = []
    fused = core.KERNEL_BLOCKS._replace(layer=lambda *a, **k: calls.append(1) or core.KERNEL_BLOCKS.layer(*a, **k))
    got = _port_scores(pcfg, tree, batch, Precision.f32(), fused)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert len(calls) == 2 * pcfg.x_layers


def test_apply_bf16_cpu_path_tracks_jax_bf16():
    jcfg, pcfg = _configs(False)
    tree = jax_lxmert_params(jcfg, seed=5)
    batch = lxmert_batch(6, jcfg, seed=6)
    want = _jax_scores(jcfg, tree, batch, JaxPrecision.bf16())
    got = _port_scores(pcfg, tree, batch, Precision.bf16())
    np.testing.assert_allclose(got, want, atol=BF16_SCORE_BAND, rtol=0)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def test_param_layout():
    """The JAX tree keeps every leaf the JAX apply reads, and the AM head's
    ``logit_W`` and the MLM head; each attention gains its fused forms; the
    registry's random init has the same layout; the matmul-kernel list of each
    model covers every ``kernel`` leaf of the tree a scorer holds."""
    jcfg, pcfg = _configs(False)
    params = params_from_jax(jax_lxmert_params(jcfg, seed=7))
    init = get_model("lxmert", overrides={**TINY_BERT, "l_layers": 2, "x_layers": 2, "r_layers": 2}).init_params(0)
    va = params["bert"]["encoder"]["x_layers"]["visual_attention"]
    assert set(va) == {"qkv", "query", "kv", "output"}
    torch.testing.assert_close(va["qkv"]["kernel"][..., :32], va["query"]["kernel"], rtol=0, atol=0)
    torch.testing.assert_close(va["qkv"]["kernel"][..., 32:], va["kv"]["kernel"], rtol=0, atol=0)
    # logit_W: the AM head am_loss trains; cls: the MLM head the MLM loss trains, which no scorer holds
    assert set(params) == {"bert", "logit_fc", "logit_W", "cls"} and set(params["cls"]) == {"predictions"}
    assert set(_leaves(params)) == set(_leaves(init))
    for tree, paths in ((scoring_params(params), lxmert.MATMUL_KERNELS),
                        (scoring_params(get_model("imagebert_a", overrides=TINY_BERT).init_params(0)),
                         imagebert_a.MATMUL_KERNELS)):
        kernel_leaves = {k for k in _leaves(tree) if k.endswith("/kernel")}
        assert kernel_leaves == {"/".join((*p, "kernel")) for p in paths}
        cast = _leaves(cast_matmul_weights(tree, torch.bfloat16, paths))
        assert {k for k, v in cast.items() if v.dtype == torch.bfloat16} == kernel_leaves


def test_registry_depth_overrides():
    spec = get_model("lxmert", overrides={"hidden_size": 64, "l_layers": 3, "x_layers": 1})
    assert (spec.config.l_layers, spec.config.x_layers, spec.config.r_layers) == (3, 1, 5)
    assert spec.config.bert.hidden_size == 64
    assert spec.featurizer_layout == "lxmert" and spec.input_keys == lxmert.INPUT_KEYS
    full = get_model("lxmert").config
    assert (full.bert.hidden_size, full.l_layers, full.r_layers, full.x_layers) == (768, 9, 5, 5)


def test_featurizer_lxmert_layout_matches_jax(tmp_path):
    lines = synthetic.make_tsv(21, seed=8) + ["not\ta\tvalid\trow"]
    tsv = tmp_path / "pairs.tsv"
    tsv.write_text("\n".join(lines) + "\n")
    labels = tmp_path / "labels.txt"
    labels.write_text("".join(f"{k}\t{v}\n" for k, v in synthetic.SYNTHETIC_LABELS.items()))
    port_fz = data.Featurizer(FullTokenizer.hf_style(VOCAB_PATH), data.load_multimodal_labels(labels))
    ref_fz = jax_data.Featurizer(JaxTokenizer.hf_style(VOCAB_PATH), jax_data.load_multimodal_labels(labels))
    got = list(data.batches_from_files([tsv], port_fz.for_model("lxmert"), 8))
    want = list(jax_data.batches_from_files([tsv], ref_fz.for_model("lxmert"), 8))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    # the ImageBERT-A layout is untouched by the label-grid change
    a_port = list(data.batches_from_files([tsv], port_fz.for_model("imagebert_a"), 8))
    a_ref = list(jax_data.batches_from_files([tsv], ref_fz.for_model("imagebert_a"), 8))
    for g, w in zip(a_port, a_ref):
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_hf_tokenizer_matches_jax():
    port, ref = FullTokenizer.hf_style(VOCAB_PATH), JaxTokenizer.hf_style(VOCAB_PATH)
    for text in [*synthetic.SYNTHETIC_QUERIES, "[CLS] keep [MASK] whole", "y" * 150, "Café, hand-bag!"]:
        assert port.tokenize(text) == ref.tokenize(text)
        assert port.encode_query(text) == ref.encode_query(text)
