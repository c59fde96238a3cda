"""The port's own copies of the host-side modules (tokenizer, TSV parsing,
featurizer, batching, synthetic data, nDCG) against the JAX package's:
the same inputs must give identical outputs."""

import numpy as np
import pytest

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu import data as jax_data
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu import eval as jax_eval
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.data import synthetic as jax_synth
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.tokenization import FullTokenizer as JaxTokenizer
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch import VOCAB_PATH, data, eval as port_eval
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import synthetic
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.tokenization import FullTokenizer

TEXTS = synthetic.SYNTHETIC_QUERIES + [
    "Café ÉLÉGANT, hand-bag (2019)!",
    "连衣裙 女 夏 red",
    "x" * 250,
    "tab\tand　ideographic space $`^",
]


@pytest.fixture(scope="module")
def tokenizers():
    return FullTokenizer.google_style(VOCAB_PATH), JaxTokenizer.google_style(VOCAB_PATH)


def test_tokenizer_matches_jax(tokenizers):
    port, ref = tokenizers
    for text in TEXTS:
        assert port.tokenize(text) == ref.tokenize(text)
        assert port.encode_query(text, 20) == ref.encode_query(text, 20)


def test_synthetic_data_is_identical():
    assert synthetic.make_tsv(30, seed=3) == jax_synth.make_tsv(30, seed=3)
    assert synthetic.make_eval_tsv(20, seed=4) == jax_synth.make_eval_tsv(20, seed=4)
    assert synthetic.SYNTHETIC_LABELS == jax_synth.SYNTHETIC_LABELS


def _write(tmp_path, lines):
    tsv = tmp_path / "pairs.tsv"
    tsv.write_text("\n".join(lines) + "\n")
    labels = tmp_path / "labels.txt"
    labels.write_text("".join(f"{k}\t{v}\n" for k, v in synthetic.SYNTHETIC_LABELS.items()))
    return tsv, labels


def test_featurized_batches_match_jax(tmp_path, tokenizers):
    lines = synthetic.make_tsv(23, seed=5) + ["not\ta\tvalid\trow"]
    tsv, labels = _write(tmp_path, lines)
    port_fz = data.Featurizer(tokenizers[0], data.load_multimodal_labels(labels))
    ref_fz = jax_data.Featurizer(tokenizers[1], jax_data.load_multimodal_labels(labels))
    port_stats, ref_stats = data.PipelineStats(), jax_data.PipelineStats()
    got = list(data.batches_from_files([tsv], port_fz.for_model("imagebert_a"), 8, port_stats))
    want = list(jax_data.batches_from_files([tsv], ref_fz.for_model("imagebert_a"), 8, ref_stats))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert (port_stats.parsed, port_stats.errors) == (ref_stats.parsed, ref_stats.errors) == (23, 1)
    assert got[-1]["valid"].sum() == 7


def test_ndcg_matches_jax():
    rng = np.random.default_rng(6)
    scores = {str(q): {str(p): float(rng.random()) for p in range(12)} for q in range(9)}
    answers = {str(q): [int(p) for p in rng.choice(12, 3, replace=False)] for q in range(10)}
    assert port_eval.evaluate_scores(scores, answers) == jax_eval.evaluate_scores(scores, answers)
    rows = {q: sorted(r, key=r.get, reverse=True)[:5] for q, r in scores.items()}
    assert port_eval.evaluate_submission(rows, answers) == jax_eval.evaluate_submission(rows, answers)
