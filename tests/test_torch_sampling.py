"""The port's hard-negative sampler against the JAX package's: the same
example dicts, in the same order, for ImageBERT-A's recipe (MLM-masked query
ids; its masking draws share the mining ``random.Random``) and ImageBERT-B's
(query filter, ``rand_query`` shuffles, word-match labels), over two epochs of
one synthetic TSV, from the same seed; and the same query-label index."""

import dataclasses
import random

import numpy as np
import pytest

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu import VOCAB_PATH
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.data import Featurizer as JaxFeaturizer
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.data import QueryLabelIndex as JaxQueryLabelIndex
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.data import sampling as jax_sampling
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.tokenization import FullTokenizer as JaxTokenizer
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import Featurizer, QueryLabelIndex
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import sampling
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.synthetic import (
    SYNTHETIC_LABELS,
    SYNTHETIC_QUERIES,
    make_tsv,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.tokenization import FullTokenizer


@pytest.fixture(scope="module")
def query_labels(tmp_path_factory):
    path = tmp_path_factory.mktemp("ql") / "query_labels.txt"
    labels = ["dress,others", "shoe  leather", "dress,dress,bag", "others"]
    path.write_text("\n".join(f"{200000 + i}\t{q}\t{labels[i % len(labels)]}"
                              for i, q in enumerate(SYNTHETIC_QUERIES)) + "\n")
    return path


def _samplers(query_labels, variant: str, seed: int):
    port = sampling.HardNegativeSampler(
        Featurizer(FullTokenizer.google_style(VOCAB_PATH), SYNTHETIC_LABELS), QueryLabelIndex.load(query_labels),
        getattr(sampling.SamplerConfig, variant)(seed))
    ref = jax_sampling.HardNegativeSampler(
        JaxFeaturizer(JaxTokenizer.google_style(VOCAB_PATH), SYNTHETIC_LABELS), JaxQueryLabelIndex.load(query_labels),
        getattr(jax_sampling.SamplerConfig, variant)(seed))
    return port, ref


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("variant", ["imagebert_a", "imagebert_b"])
def test_sampler_yields_the_jax_examples(query_labels, variant, seed):
    port, ref = _samplers(query_labels, variant, seed)
    lines = make_tsv(60, seed=seed + 1)
    for _ in range(2):  # the hard-negative ramp moves with the epoch
        got, want = list(port.examples(lines)), list(ref.examples(lines))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
                assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)


def test_query_label_index_equals_jax(query_labels):
    port, ref = QueryLabelIndex.load(query_labels), JaxQueryLabelIndex.load(query_labels)
    assert (port.rows, port.by_tail_word, port.by_label, port.query_set) == (
        ref.rows, ref.by_tail_word, ref.by_label, ref.query_set)
    assert QueryLabelIndex.parse_row(port.rows[1]) == JaxQueryLabelIndex.parse_row(ref.rows[1])


def test_mlm_masking_equals_jax():
    tok = FullTokenizer.google_style(VOCAB_PATH)
    tokens = ["[CLS]"] + tok.tokenize("red lace sling dress women summer") + ["[SEP]"]
    words = list(tok.vocab.keys())
    got = sampling.mask_query_tokens(tokens, tok, random.Random(3), words)
    want = jax_sampling.mask_query_tokens(tokens, JaxTokenizer.google_style(VOCAB_PATH), random.Random(3), words)
    assert got == want
