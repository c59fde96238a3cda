"""The port's int8 serving path (``ops/quant.py``) against the JAX package's:
each case of ``tests/test_quant.py`` on the same numpy inputs, the int8 tree
of the port equal leaf for leaf to ``params_from_jax`` of JAX's int8 tree
(the fused q/k/v nodes and the path names), whole-model int8 scores of the
four scorers at TINY within 1e-5 of JAX's in f32, rank fidelity at MID in
both modes (``tests/test_quant.py``'s thresholds), and ``cli/export.py
--quantize``: ``meta.json["quantize"]`` and the reloaded artifact equal to
the engine on the CPU."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import Precision as JaxPrecision
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import get_model as jax_get_model
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.ops import quant as jax_quant
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import params_from_jax, params_to_jax, save_npz
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint.npz import cast_matmul_weights, flatten_tree
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.batchspec import example_batch
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.eval import evaluate_scores
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import Precision, get_model
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops import quant
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.parallel import ScoringEngine
from torch_parity import TINY, numpy_like

LX_DEPTHS = {"l_layers": 2, "x_layers": 2, "r_layers": 1}
MODELS = ["imagebert_a", "imagebert_b", "imagebert_c", "lxmert"]
MID = {"hidden_size": 128, "num_hidden_layers": 4, "num_attention_heads": 4, "intermediate_size": 512}
MODES = {"full": None, "ffn": ("ffn",)}


def _overrides(name, base=TINY):
    return {**base, **LX_DEPTHS} if name == "lxmert" else dict(base)


def _jax_tree(name, seed=0, base=TINY):
    """Numpy params in the JAX tree layout of ``name`` at ``base``'s size."""
    spec = jax_get_model(name, overrides=_overrides(name, base))
    return numpy_like(jax.eval_shape(lambda: spec.init_params(jax.random.key(0))), seed)


def _np(t):
    return np.asarray(t.float() if t.dtype == torch.bfloat16 else t)


def test_quantize_kernel_matches_jax():
    rng = np.random.default_rng(0)
    k = rng.standard_normal((64, 48)).astype(np.float32)
    got, want = quant.quantize_kernel(torch.from_numpy(k)), jax_quant.quantize_kernel(jnp.asarray(k))
    assert got[quant.QUANT_KERNEL].dtype == torch.int8
    np.testing.assert_array_equal(got[quant.QUANT_KERNEL].numpy(), np.asarray(want[quant.QUANT_KERNEL]))
    np.testing.assert_array_equal(got[quant.QUANT_SCALE].numpy(), np.asarray(want[quant.QUANT_SCALE]))
    # the JAX case's bound: symmetric per-channel int8, error <= scale/2 = amax/254 per element
    deq = got[quant.QUANT_KERNEL].float() * got[quant.QUANT_SCALE]
    assert (np.abs(deq.numpy() - k) <= np.abs(k).max(axis=0) / 254 + 1e-7).all()


def test_stacked_kernel_quantization_matches_jax_and_per_layer():
    rng = np.random.default_rng(4)
    k = rng.standard_normal((3, 16, 8)).astype(np.float32)
    got, want = quant.quantize_kernel(torch.from_numpy(k)), jax_quant.quantize_kernel(jnp.asarray(k))
    for name in (quant.QUANT_KERNEL, quant.QUANT_SCALE):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    for layer in range(3):
        one = quant.quantize_kernel(torch.from_numpy(k[layer]))
        assert torch.equal(got[quant.QUANT_KERNEL][layer], one[quant.QUANT_KERNEL])
        assert torch.equal(got[quant.QUANT_SCALE][layer], one[quant.QUANT_SCALE])


@pytest.mark.parametrize("shape", [(16, 64, 48), (4, 768, 2), (7, 5, 768), (2, 3, 37, 40)])
def test_dense_q8_matches_jax(shape):
    """The JAX case (16x64 @ 64x48) and the shapes the card pads: a 2-wide head, K=5 (B's box dense),
    a 3-D input of ragged width."""
    rng = np.random.default_rng(1)
    *lead, k_in, n = shape
    k = rng.standard_normal((k_in, n)).astype(np.float32)
    b = rng.standard_normal((n,)).astype(np.float32)
    x = rng.standard_normal((*lead, k_in)).astype(np.float32)
    want = np.asarray(jax_quant.dense_q8({**jax_quant.quantize_kernel(jnp.asarray(k)), "bias": jnp.asarray(b)},
                                         jnp.asarray(x)))
    got = quant.dense_q8({**quant.quantize_kernel(torch.from_numpy(k)), "bias": torch.from_numpy(b)},
                         torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # and close to the f32 dense: two int8 roundings over the contraction, ~1% relative (the JAX bound)
    assert np.abs(got - (x @ k + b)).max() <= 0.03 * np.abs(x @ k + b).max() + 0.03 * np.sqrt(k_in)


def test_quantize_dense_tree_skips_and_marks():
    tree = {
        "enc": {"kernel": torch.ones(8, 8), "bias": torch.zeros(8)},
        "head": {"kernel": torch.ones(8, 2), "bias": torch.zeros(2)},
        "ln": {"gamma": torch.ones(8), "beta": torch.zeros(8)},
    }
    q = quant.quantize_dense_tree(tree, skip_paths=("head",))
    assert quant.is_quantized(q["enc"]) and not quant.is_quantized(q["head"])
    assert "kernel" not in q["enc"] and "kernel" in q["head"]
    assert q["ln"]["gamma"].shape == (8,)


def test_cast_residual_bf16_keeps_scales_f32():
    tree = quant.quantize_dense_tree({"enc": {"kernel": torch.ones(4, 8, 8), "bias": torch.zeros(4, 8)}})
    tree["emb"] = torch.ones(10, 8)
    tree["cls"] = {"w": torch.ones(3)}
    out = quant.cast_residual_bf16(tree, skip_paths=("cls",))
    assert out["enc"][quant.QUANT_KERNEL].dtype == torch.int8
    assert out["enc"][quant.QUANT_SCALE].dtype == torch.float32
    assert out["enc"]["bias"].dtype == torch.bfloat16
    assert out["emb"].dtype == torch.bfloat16
    assert out["cls"]["w"].dtype == torch.float32
    jax_out = jax_quant.cast_residual_bf16(
        jax.tree.map(lambda t: jnp.asarray(_np(t)) if t.dtype != torch.int8 else jnp.asarray(t.numpy()), tree),
        skip_paths=("cls",))
    for key, leaf in flatten_tree(jax.tree.map(np.asarray, jax_out)).items():
        node = out
        for part in key.split("/"):
            node = node[part]
        assert str(leaf.dtype) == str(node.dtype).replace("torch.", ""), key


def test_quantize_only_paths_ffn():
    spec = get_model("imagebert_a", overrides=TINY)
    q = quant.quantize_dense_tree(spec.init_params(0), skip_paths=("cls",), only_paths=("ffn",))
    enc = q["bert"]["encoder"]
    assert quant.is_quantized(enc["ffn"]["intermediate"]) and quant.is_quantized(enc["ffn"]["output"]["dense"])
    assert not quant.is_quantized(enc["attention"]["qkv"])
    assert not quant.is_quantized(enc["attention"]["output"]["dense"])
    assert not quant.is_quantized(q["bert"]["pooler"]["dense"])
    assert not quant.is_quantized(q["cls"]["predictions"]["transform"]["dense"])


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            assert got[k].dtype == want[k].dtype, f"{path}/{k}"
            assert torch.equal(got[k], want[k]), f"{path}/{k}"


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", MODELS)
def test_port_int8_tree_equals_jax_int8_tree(name, mode):
    """quantize_dense_tree(params_from_jax(t)) == params_from_jax(JAX's quantize_dense_tree(t)), leaf for
    leaf: the fused qkv / kv nodes quantise to the concatenation of JAX's q/k/v nodes."""
    tree = _jax_tree(name)
    only = MODES[mode]
    got = quant.quantize_dense_tree(params_from_jax(tree), skip_paths=("cls",), only_paths=only)
    jax_q = jax_quant.quantize_dense_tree(jax.tree.map(jnp.asarray, tree), skip_paths=("cls",), only_paths=only)
    want = params_from_jax(jax.tree.map(np.asarray, jax_q))
    _assert_trees_equal(got, want)
    n_int8 = sum(1 for v in _flat_torch(got).values() if v.dtype == torch.int8)
    assert n_int8 >= (2 if mode == "ffn" else 6)
    # and back: params_to_jax splits the fused int8 nodes into JAX's q/k/v
    want_flat = flatten_tree(jax.tree.map(np.asarray, jax_q))
    for key, leaf in flatten_tree(params_to_jax(got)).items():
        assert leaf.dtype == want_flat[key].dtype, key
        np.testing.assert_array_equal(leaf, want_flat[key], err_msg=key)


def _jax_int8_scores(name, tree, batch, only):
    spec = jax_get_model(name, overrides=_overrides(name))
    q = jax_quant.quantize_dense_tree(jax.tree.map(jnp.asarray, tree), skip_paths=("cls",), only_paths=only)
    apply = jax.jit(lambda p, b: spec.apply(p, b, spec.config, JaxPrecision.f32())["score"])
    return np.asarray(apply(q, {k: jnp.asarray(v) for k, v in batch.items()}))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", MODELS)
def test_int8_scores_match_jax(name, mode):
    """Whole-model int8 scores at TINY, f32, through ScoringEngine on the CPU, within 1e-5 of JAX's."""
    tree = _jax_tree(name, seed=3)
    spec = get_model(name, overrides=_overrides(name))
    batch = example_batch(name, spec.config, 12, np.random.default_rng(2))
    params = spec.from_jax(quant.quantize_dense_tree(params_from_jax(tree), skip_paths=("cls",),
                                                     only_paths=MODES[mode]))
    got = ScoringEngine(spec, params, device="cpu").score_batch(batch).numpy()
    want = _jax_int8_scores(name, tree, batch, MODES[mode])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["imagebert_a", "imagebert_b"])
def test_quantize_for_serving_modes(name):
    """``quantize_for_serving`` = quantise on the JAX-layout tree, cls skipped, then the spec's from_jax; the
    bf16 residual keeps the scales and cls f32, and the engine and the kernels' route score it."""
    spec = get_model(name, overrides=TINY)
    params = spec.init_params(1)
    for mode, only in (("int8", None), ("int8-ffn", ("ffn",))):
        got = quant.quantize_for_serving(spec, params, mode, bf16_residual=False)
        want = spec.from_jax(quant.quantize_dense_tree(params_from_jax(params_to_jax(params)), skip_paths=("cls",),
                                                       only_paths=only))
        _assert_trees_equal(got, want)
        if name == "imagebert_b":
            assert "kernel" in got["kdd_conv1"]  # the label conv's band: unquantised, as JAX's taps
        res = quant.quantize_for_serving(spec, params, mode, bf16_residual=True)
        flat = {k: v for k, v in _flat_torch(res).items()}
        assert all(v.dtype == torch.float32 for k, v in flat.items() if k.endswith(quant.QUANT_SCALE))
        assert all(v.dtype == torch.float32 for k, v in flat.items() if k.startswith("cls/"))
        assert flat["bert/embeddings/word_embeddings"].dtype == torch.bfloat16
        batch = example_batch(name, spec.config, 6, np.random.default_rng(4))
        for backend in ("xla", "pallas_packed"):
            s = ScoringEngine(spec, res, device="cpu", precision=Precision.bf16(),
                              attention_backend=backend).score_batch(batch)
            assert torch.isfinite(s).all()
    with pytest.raises(ValueError, match="unknown quantize mode"):
        quant.quantize_for_serving(spec, params, "int4", bf16_residual=False)


def _flat_torch(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_torch(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_cast_matmul_weights_leaves_int8_nodes():
    spec = get_model("imagebert_a", overrides=TINY)
    q = quant.quantize_dense_tree(spec.init_params(0), skip_paths=("cls",), only_paths=("ffn",))
    out = cast_matmul_weights(q, torch.bfloat16, spec.matmul_kernels)
    ffn = out["bert"]["encoder"]["ffn"]["intermediate"]
    assert ffn[quant.QUANT_KERNEL].dtype == torch.int8 and ffn[quant.QUANT_SCALE].dtype == torch.float32
    assert out["bert"]["encoder"]["attention"]["qkv"]["kernel"].dtype == torch.bfloat16


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", ["imagebert_a", "imagebert_b"])
def test_int8_rank_fidelity(name, mode):
    """``tests/test_quant.py``'s case through the port: its params (JAX's init from key 0 at MID), its batch
    (20 queries x 30 products), its thresholds: mean Kendall tau >= 0.98, min >= 0.95, mean top-5 overlap
    >= 0.95, min >= 0.8, nDCG@5 delta <= 0.01."""
    spec = get_model(name, overrides=MID)
    jspec = jax_get_model(name, overrides=MID)
    params = spec.from_jax(params_from_jax(jax.tree.map(np.asarray, jspec.init_params(jax.random.key(0)))))
    n_queries, n_products = 20, 30
    batch = example_batch(name, spec.config, n_queries * n_products, np.random.default_rng(5))
    f32 = ScoringEngine(spec, params, device="cpu").score_batch(batch).numpy()
    qparams = spec.from_jax(quant.quantize_dense_tree(params_from_jax(params_to_jax(params)),
                                                      only_paths=MODES[mode]))
    q8 = ScoringEngine(spec, qparams, device="cpu").score_batch(batch).numpy()
    report = rank_fidelity(f32, q8, n_queries, n_products)
    assert report["mean_tau"] >= 0.98 and report["min_tau"] >= 0.95, report
    assert report["mean_top5"] >= 0.95 and report["min_top5"] >= 0.8, report
    assert report["ndcg_delta"] <= 0.01, report


def rank_fidelity(f32, q8, n_queries, n_products) -> dict:
    taus, overlaps = [], []
    f32_table, q8_table, answers = {}, {}, {}
    for q in range(n_queries):
        a, b = f32[q * n_products:(q + 1) * n_products], q8[q * n_products:(q + 1) * n_products]
        ii, jj = np.triu_indices(n_products, 1)
        taus.append(float(np.mean(np.sign(a[ii] - a[jj]) * np.sign(b[ii] - b[jj]))))
        top_a, top_b = np.argsort(-a)[:5], np.argsort(-b)[:5]
        overlaps.append(len(set(top_a) & set(top_b)) / 5)
        f32_table[str(q)] = {str(p): float(a[p]) for p in range(n_products)}
        q8_table[str(q)] = {str(p): float(b[p]) for p in range(n_products)}
        answers[str(q)] = [str(p) for p in top_a]
    ndcg_f32 = evaluate_scores(f32_table, answers)
    assert ndcg_f32 == pytest.approx(1.0)
    return {"mean_tau": float(np.mean(taus)), "min_tau": float(np.min(taus)), "mean_top5": float(np.mean(overlaps)),
            "min_top5": float(np.min(overlaps)), "ndcg_delta": ndcg_f32 - evaluate_scores(q8_table, answers)}


@pytest.mark.parametrize("mode", ["int8", "int8-ffn"])
def test_export_cli_quantize(tmp_path, mode):
    """``cli/export.py --quantize``: meta.json records the mode, and the reloaded artifact scores as the engine
    on the same int8 tree, on the CPU."""
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import export as export_cli
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.serving import load_scorer

    spec = get_model("imagebert_a", overrides=TINY)
    params = spec.init_params(2)
    ckpt = tmp_path / "a.npz"
    save_npz(ckpt, params_to_jax(params))
    out = tmp_path / "art"
    export_cli.main(["--model", "imagebert_a", "--checkpoint", str(ckpt), "--batch-size", "4", "--quantize", mode,
                     "--device", "cpu", "--config-overrides", json.dumps(TINY), "--out", str(out)])
    meta = json.loads((out / "meta.json").read_text())
    assert meta["quantize"] == mode and meta["precision"] == "f32"
    batch = example_batch("imagebert_a", spec.config, 4, np.random.default_rng(7))
    engine = ScoringEngine(spec, quant.quantize_for_serving(spec, params, mode, bf16_residual=False), device="cpu")
    want = engine.score_batch(batch).numpy()
    scorer = load_scorer(out)
    got = scorer({k: torch.from_numpy(v) for k, v in batch.items() if k in scorer.feature_keys})
    np.testing.assert_array_equal(got, want)


def test_export_cli_quantize_refusals(tmp_path):
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import export as export_cli

    with pytest.raises(SystemExit) as e:
        export_cli.main(["--model", "two_tower", "--side", "query", "--quantize", "int8", "--device", "cpu",
                         "--out", str(tmp_path / "t")])
    assert e.value.code == 2
