"""The port's memmapped catalog (``data/catalog.py``) and its catalog-scale
CLIs against the JAX package's, mirroring ``tests/test_catalog.py``:

* ``build_catalog``'s shards byte-equal to JAX's from the same entries, and
  the reader's chunks and row gathers;
* ``recall_chunked`` equal to JAX's over the same directory (indices
  exactly, ties included, scores within 1e-6);
* ``rerank_batch`` bit-equal to JAX's in all four layouts, and to the
  ``Featurizer`` layouts but for the catalog's float16 features;
* ``cli/bench_recall_3m.py`` at toy scale: the same shards, byte for byte,
  and the same recall curve as ``scripts/bench_recall_3m.py``, and its
  float64 oracle check;
* ``cli/recall.py build --packed`` then ``query`` from the packed directory.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.data import catalog as jax_catalog
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch import VOCAB_PATH
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import bench_recall_3m
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import recall as recall_cli
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import (
    CatalogDataset,
    Featurizer,
    build_catalog,
    load_multimodal_labels,
    parse_line,
    recall_at_k,
    recall_chunked,
    rerank_batch,
    stack_examples,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.synthetic import SYNTHETIC_LABELS, make_row, make_tsv
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import get_model
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.tokenization import FullTokenizer
from torch_parity import TINY

REPO = Path(__file__).resolve().parents[1]


def _entries(n, d=16, seed=0, with_features=False):
    rng = np.random.default_rng(seed)
    for i in range(n):
        e = {"product_id": np.int64(900_000 + i), "embedding": rng.standard_normal(d).astype(np.float32)}
        if with_features:
            e["features"] = rng.standard_normal((10, 32)).astype(np.float32)
            e["num_boxes"] = np.int32(rng.integers(1, 11))
        yield e


def _same_files(a: Path, b: Path) -> list[str]:
    """The files of two directories that differ (or that one lacks)."""
    names = sorted({p.name for p in a.iterdir()} | {p.name for p in b.iterdir()})
    return [n for n in names if not ((a / n).exists() and (b / n).exists()
                                     and (a / n).read_bytes() == (b / n).read_bytes())]


def test_build_catalog_matches_jax_and_reads_back(tmp_path):
    manifest = build_catalog(_entries(23, with_features=True), tmp_path / "cat", shard_size=7)
    jax_catalog.build_catalog(_entries(23, with_features=True), tmp_path / "jax", shard_size=7)
    assert _same_files(tmp_path / "cat", tmp_path / "jax") == []
    assert manifest["num_instances"] == 23 and manifest["label_tokenizer"] == "google"
    ds = CatalogDataset(tmp_path / "cat")
    assert len(ds) == 23 and ds.dim == 16
    np.testing.assert_array_equal(ds.product_ids(), 900_000 + np.arange(23))
    starts, slabs = zip(*ds.embedding_chunks(chunk_rows=5))
    assert all(s.shape[0] <= 5 for s in slabs) and list(starts) == [0, 5, 7, 12, 14, 19, 21]
    want = np.stack([np.asarray(e["embedding"], np.float16) for e in _entries(23, with_features=True)])
    np.testing.assert_array_equal(np.concatenate(slabs), want)
    rows = ds.rows(np.array([22, 0, 7, 6]))
    jrows = jax_catalog.CatalogDataset(tmp_path / "cat").rows(np.array([22, 0, 7, 6]))
    assert rows["features"].dtype == np.float32 and rows.keys() == jrows.keys()
    for key in rows:
        np.testing.assert_array_equal(rows[key], jrows[key], err_msg=key)
    np.testing.assert_array_equal(rows["product_id"], [900_022, 900_000, 900_007, 900_006])


@pytest.mark.parametrize("case", ["random", "duplicates"])
def test_recall_chunked_matches_jax(tmp_path, case):
    """Over the same directory, chunks crossing shards, a ragged tail and (for
    "duplicates") exact ties across chunks: JAX's indices and scores."""
    entries = list(_entries(200, d=16, seed=1))
    if case == "duplicates":
        for i, e in enumerate(entries):
            e["embedding"] = entries[i % 23]["embedding"]
    build_catalog(entries, tmp_path / "cat", shard_size=64)
    q = np.random.default_rng(2).standard_normal((9, 16)).astype(np.float32)
    s, idx = recall_chunked(q, CatalogDataset(tmp_path / "cat"), k=7, chunk_rows=50, device="cpu")
    js, jidx = jax_catalog.recall_chunked(q, jax_catalog.CatalogDataset(tmp_path / "cat"), k=7, chunk_rows=50)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(s, js, atol=1e-6, rtol=0)
    assert (np.diff(s, axis=1) <= 0).all()


def test_recall_chunked_catalog_smaller_than_k(tmp_path):
    build_catalog(_entries(3, d=8, seed=3), tmp_path / "cat", shard_size=2)
    q = np.random.default_rng(4).standard_normal((2, 8)).astype(np.float32)
    s, idx = recall_chunked(q, CatalogDataset(tmp_path / "cat"), k=5, chunk_rows=2, device="cpu")
    js, jidx = jax_catalog.recall_chunked(q, jax_catalog.CatalogDataset(tmp_path / "cat"), k=5, chunk_rows=2)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(s, js)
    assert (idx[:, 3:] == -1).all()


def test_recall_at_k_curve():
    retrieved = np.array([[3, 1, 2, -1], [9, 8, 7, 6]])
    truth = {0: [1, 5], 1: [6]}
    curve = recall_at_k(retrieved, truth, [1, 2, 4])
    assert curve == jax_catalog.recall_at_k(retrieved, truth, [1, 2, 4])
    assert curve[1] == 0.0 and curve[2] == pytest.approx(1 / 3) and curve[4] == pytest.approx(2 / 3)
    assert list(curve) == [1, 2, 4]


def test_bench_recall_3m_matches_jax_script(tmp_path):
    """The 3M driver at toy scale: the shards it streams are the JAX script's
    byte for byte, the curve is the JAX script's, top-50 at low noise finds
    every planted row, and the device's top-K passes the float64 oracle."""
    argv = ["--products", "3000", "--queries", "16", "--dim", "16", "--noise", "0.1", "--shard-size", "1024",
            "--chunk-rows", "700", "--ks", "1,5,50"]
    line = bench_recall_3m.run([*argv, "--out-dir", str(tmp_path / "cat"), "--device", "cpu",
                                "--check-queries", "8"])
    r = subprocess.run([sys.executable, "scripts/bench_recall_3m.py", *argv, "--out-dir", str(tmp_path / "jax")],
                       cwd=REPO, env={**os.environ, "JAX_PLATFORMS": "cpu"}, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    assert _same_files(tmp_path / "cat", tmp_path / "jax") == []
    assert line["products"] == 3000 and line["recall_at_k"] == want["recall_at_k"]
    curve = line["recall_at_k"]
    assert curve["50"] == 1.0 and curve["50"] >= curve["5"] >= curve["1"]
    assert line["check"]["ok"] and line["check"]["queries"] == 8 and line["check"]["k"] == 50


def test_rerank_batch_matches_jax_and_featurizer(tmp_path):
    """The packed-catalog rerank assembly reproduces every layout of the
    Featurizer (features but for the catalog's float16) and JAX's
    rerank_batch bit for bit."""
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.data import Featurizer as JaxFeaturizer
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.tokenization import FullTokenizer as JaxTokenizer

    labels_path = tmp_path / "labels.txt"
    labels_path.write_text("\n".join(f"{k}\t{v}" for k, v in SYNTHETIC_LABELS.items()) + "\n")
    labels = load_multimodal_labels(labels_path)
    rng = np.random.default_rng(5)
    product_exs = [parse_line(make_row(rng, product_id=700 + i, query_id=0)) for i in range(6)]
    query_exs = [parse_line(make_row(rng, product_id=0, query_id=40 + i,
                                     query="sen department of sweet dress" if i == 0 else None)) for i in range(3)]
    google = FullTokenizer.google_style(VOCAB_PATH)
    tower_fz = Featurizer(google, labels)
    build_catalog(({"product_id": np.int64(ex.product_id), "embedding": rng.standard_normal(8).astype(np.float32),
                    **{f: tower_fz.imagebert_b(ex)[f] for f in recall_cli.RERANK_FIELDS}} for ex in product_exs),
                  tmp_path / "cat", shard_size=4)
    rows = CatalogDataset(tmp_path / "cat").rows(np.array([0, 1, 1, 2, 2, 3]))
    pair_q = [0, 0, 1, 1, 2, 2]
    for model in ("imagebert_a", "imagebert_b", "imagebert_c", "lxmert"):
        spec = get_model(model, overrides=TINY)
        tok = FullTokenizer.hf_style(VOCAB_PATH) if model == "lxmert" else google
        fz = Featurizer(tok, labels, sen2forest=spec.sen2forest)
        q_ids = [fz.query_token_ids(query_exs[q]) for q in pair_q]
        qids = np.asarray([query_exs[q].query_id for q in pair_q], np.int64)
        got = rerank_batch(model, q_ids, qids, rows)
        jtok = JaxTokenizer.hf_style(VOCAB_PATH) if model == "lxmert" else JaxTokenizer.google_style(VOCAB_PATH)
        jfz = JaxFeaturizer(jtok, labels, sen2forest=spec.sen2forest)
        assert q_ids == [jfz.query_token_ids(query_exs[q]) for q in pair_q]
        want_jax = jax_catalog.rerank_batch(model, q_ids, qids, rows)
        want = stack_examples([fz.for_model(model)(dataclasses.replace(
            product_exs[p], query=query_exs[q].query, query_id=query_exs[q].query_id))
            for q, p in zip(pair_q, [0, 1, 1, 2, 2, 3])])
        assert got.keys() == want.keys() == want_jax.keys(), model
        for key in got:
            assert got[key].dtype == want_jax[key].dtype == want[key].dtype, (model, key)
            np.testing.assert_array_equal(got[key], want_jax[key], err_msg=f"{model}.{key}")
            expect = want[key].astype(np.float16).astype(np.float32) if key == "features" else want[key]
            np.testing.assert_array_equal(got[key], expect, err_msg=f"{model}.{key}")


def test_rerank_batch_label_lens_fallback():
    rows = {"product_id": np.arange(2, dtype=np.int64), "num_boxes": np.array([2, 1], np.int32),
            "boxes": np.zeros((2, 10, 5), np.float32), "features": np.zeros((2, 10, 16), np.float32),
            "label_ids": np.zeros((2, 10, 8), np.int32)}
    rows["label_ids"][0, 0, :3] = [5, 6, 7]
    rows["label_ids"][1, 0, :8] = 9
    got = rerank_batch("imagebert_b", [[101, 102], [101, 103]], np.zeros(2, np.int64), rows)
    np.testing.assert_array_equal(got["label_lens"][0], [3] + [0] * 9)
    np.testing.assert_array_equal(got["label_lens"][1], [8] + [0] * 9)
    with pytest.raises(ValueError, match="unknown model"):
        rerank_batch("two_tower", [[101, 102], [101, 103]], np.zeros(2, np.int64), rows)


def test_recall_cli_packed_roundtrip(tmp_path, monkeypatch):
    """cli/recall.py build --packed --store-features, then query from the packed directory."""
    monkeypatch.setenv("KMR_TOWER_CONFIG_OVERRIDES", json.dumps(
        {"bert": {**TINY, "num_hidden_layers": 1, "max_position_embeddings": 64}, "embed_dim": 16}))
    tsv = tmp_path / "pairs.tsv"
    tsv.write_text("\n".join(make_tsv(24, seed=11)) + "\n")
    labels = tmp_path / "labels.txt"
    labels.write_text("\n".join(f"{k}\t{v}" for k, v in SYNTHETIC_LABELS.items()) + "\n")
    cat = tmp_path / "cat"
    common = ["--tsv", str(tsv), "--labels", str(labels), "--device", "cpu"]
    recall_cli.main(["build", *common, "--out", str(cat), "--packed", "--store-features", "--shard-size", "10"])
    ds = CatalogDataset(cat)
    assert set(recall_cli.RERANK_FIELDS) <= set(ds.fields) and ds.shard_sizes == [10, 10, 4]
    out = tmp_path / "recall.tsv"
    recall_cli.main(["query", *common, "--catalog", str(cat), "--out", str(out), "--k", "3", "--chunk-rows", "8"])
    lines = out.read_text().splitlines()
    assert len(lines) == 24
    pids = {int(p) for p in ds.product_ids()}
    for ln in lines:
        _, tops = ln.split("\t")
        assert len(tops.split(",")) == 3 and all(int(p) in pids for p in tops.split(","))
