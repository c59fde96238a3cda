"""The port's packed shards (``data/packed.py``, ``cli/build_packed.py``)
against the JAX package's ``data/packed.py`` and ``scripts/build_packed.py``.

The same sampler examples written by either ``write_packed_shards`` give
byte-equal directories; ``PackedDataset.batches`` yields JAX's batches bit for
bit over 2 epochs (one and two processes, with and without the remainder, a
batch spanning shards); a skipped prefix is planned by index and never read;
a directory from the port's ``cli/build_packed.py`` equals one written from
the JAX sampler on the same TSV and seed, and loads in JAX's
``PackedDataset``. Every comparison is exact: the format is a byte format.
"""

import json

import numpy as np
import pytest

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu import data as jax_data
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.tokenization import FullTokenizer as JaxTokenizer
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch import VOCAB_PATH
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import build_packed
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import (
    MANIFEST,
    Featurizer,
    HardNegativeSampler,
    PackedDataset,
    QueryLabelIndex,
    SamplerConfig,
    load_multimodal_labels,
    write_packed_shards,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.synthetic import (
    SYNTHETIC_LABELS,
    SYNTHETIC_QUERIES,
    make_tsv,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.tokenization import FullTokenizer

SHARD = 16  # instances a shard: the synthetic TSV's ~70 instances span five shards, the last one short


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("packed")
    (d / "train.tsv").write_text("\n".join(make_tsv(40, seed=3)) + "\n")
    (d / "labels.txt").write_text("\n".join(f"{k}\t{v}" for k, v in SYNTHETIC_LABELS.items()) + "\n")
    (d / "query_labels.txt").write_text(
        "\n".join(f"{300000 + i}\t{q}\tdress,others" for i, q in enumerate(SYNTHETIC_QUERIES)) + "\n")
    return d


def _examples(files, model: str) -> list[dict]:
    """The port sampler's examples over the TSV (A's recipe: MLM fields; B's: word-match fields)."""
    cfg = SamplerConfig.imagebert_a(0) if model == "imagebert_a" else SamplerConfig.imagebert_b(0)
    sampler = HardNegativeSampler(Featurizer(FullTokenizer.google_style(VOCAB_PATH),
                                             load_multimodal_labels(files / "labels.txt")),
                                  QueryLabelIndex.load(files / "query_labels.txt"), cfg)
    return list(sampler.examples((files / "train.tsv").read_text().splitlines(keepends=True)))


def _same_directory(a, b) -> None:
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


@pytest.fixture(scope="module")
def shards(files, tmp_path_factory):
    """One directory per model's examples, written by the port."""
    out = {}
    for model in ("imagebert_a", "imagebert_b"):
        d = tmp_path_factory.mktemp(model)
        write_packed_shards(_examples(files, model), d, shard_size=SHARD)
        out[model] = d
    return out


@pytest.mark.parametrize("model,dtype,max_instances", [("imagebert_a", np.float16, None),
                                                       ("imagebert_b", np.float16, None),
                                                       ("imagebert_a", np.float32, 37)])
def test_shards_byte_equal_to_jax(files, tmp_path, model, dtype, max_instances):
    examples = _examples(files, model)
    got = write_packed_shards(examples, tmp_path / "port", SHARD, dtype, max_instances, meta={"tokenizer": "google"})
    want = jax_data.write_packed_shards(examples, tmp_path / "jax", SHARD, dtype, max_instances,
                                        meta={"tokenizer": "google"})
    assert got == want and len(got["shard_sizes"]) > 2
    _same_directory(tmp_path / "port", tmp_path / "jax")
    if model == "imagebert_b":
        assert {"word_match_labels", "word_match_weights"} <= set(got["fields"])
    else:
        assert {"masked_lm_positions", "masked_lm_ids", "masked_lm_weights"} <= set(got["fields"])


def _assert_same_batches(got: list[dict], want: list[dict]) -> None:
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


@pytest.mark.parametrize("batch_size,process_id,process_count,drop_remainder",
                         [(8, 0, 1, True), (12, 0, 1, False), (8, 0, 2, True), (8, 1, 2, True), (5, 1, 2, False)])
@pytest.mark.parametrize("model", ["imagebert_a", "imagebert_b"])
def test_batches_bit_equal_to_jax(shards, model, batch_size, process_id, process_count, drop_remainder):
    kw = dict(epochs=2, seed=7, drop_remainder=drop_remainder, process_id=process_id, process_count=process_count)
    got = list(PackedDataset(shards[model]).batches(batch_size, **kw))
    want = list(jax_data.PackedDataset(shards[model]).batches(batch_size, **kw))
    _assert_same_batches(got, want)
    assert got[0]["features"].dtype == np.float32  # stored float16, cast when assembled


def test_oversized_batch_raises_as_jax(shards):
    n = len(PackedDataset(shards["imagebert_a"]))
    for cls in (PackedDataset, jax_data.PackedDataset):
        with pytest.raises(ValueError, match="exceeds"):
            next(cls(shards["imagebert_a"]).batches(n + 1))


@pytest.mark.parametrize("skip", [0, 3, 11])
def test_skip_plans_without_reading(shards, skip, monkeypatch):
    """A resumed stream: the batches after ``skip`` equal those of a stream that
    skips none, and only they are assembled (no gather of a skipped batch)."""
    ds = PackedDataset(shards["imagebert_a"])
    want = list(ds.batches(8, epochs=2, seed=3))[skip:]
    assembled = []
    real = ds._assemble
    monkeypatch.setattr(ds, "_assemble", lambda parts: assembled.append(parts) or real(parts))
    got = list(ds.batches(8, epochs=2, seed=3, skip=skip))
    _assert_same_batches(got, want)
    assert len(assembled) == len(got)


def test_build_packed_cli_equals_jax_and_loads_in_jax(files, tmp_path):
    report = build_packed.main(["--model", "imagebert_b", "--train-tsv", str(files / "train.tsv"), "--labels",
                                str(files / "labels.txt"), "--query-labels", str(files / "query_labels.txt"),
                                "--out", str(tmp_path / "port"), "--shard-size", str(SHARD), "--seed", "5"])
    # the JAX package's scripts/build_packed.py on the same TSV and seed, in process
    fz = jax_data.Featurizer(JaxTokenizer.google_style(VOCAB_PATH),
                             jax_data.load_multimodal_labels(files / "labels.txt"))
    sampler = jax_data.HardNegativeSampler(fz, jax_data.QueryLabelIndex.load(files / "query_labels.txt"),
                                           jax_data.SamplerConfig.imagebert_b(5))
    with open(files / "train.tsv", encoding="utf-8") as f:
        jax_data.write_packed_shards(sampler.examples(f), tmp_path / "jax", shard_size=SHARD,
                                     feature_dtype=np.dtype("float16"))
    _same_directory(tmp_path / "port", tmp_path / "jax")
    manifest = json.loads((tmp_path / "port" / MANIFEST).read_text())
    assert report["num_instances"] == manifest["num_instances"] > 0
    assert report["bytes"] == sum(p.stat().st_size for p in (tmp_path / "port").iterdir())
    got = list(jax_data.PackedDataset(tmp_path / "port").batches(8, epochs=1, seed=1))
    _assert_same_batches(got, list(PackedDataset(tmp_path / "port").batches(8, epochs=1, seed=1)))
