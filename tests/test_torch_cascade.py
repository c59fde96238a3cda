"""Two-tower training, recall and the recall -> cross-encoder cascade through
the port's CLIs, mirroring ``tests/test_cascade.py`` and held against the JAX
package's scripts on one checkpoint.

At a tiny config (``KMR_TOWER_CONFIG_OVERRIDES``, ``KMR_CONFIG_OVERRIDES``)
on 32 distinct (query, product) rows: ``cli/train.py --model two_tower``
learns (in-batch accuracy past 0.5 in 80 steps) and writes ``step_80.npz``,
which both packages then load. ``cli/recall.py`` and ``scripts/recall.py``
(run in this process) build the same catalog (float16 embeddings within 1e-5
before the cast, so within one float16 ulp after it; every other field byte
for byte), write the same ``recall.tsv`` and the same recall curve;
``cli/cascade.py`` and ``scripts/cascade.py`` write the same rows and the
same recall@K and nDCG@5, from a TSV catalog and from a packed one, with one
cross-encoder npz (ImageBERT-B, f32). The modules of the slice import no JAX.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import BertConfig as JaxBertConfig
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import save_npz
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import cascade as cascade_cli
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import recall as recall_cli
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import train as train_cli
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import CatalogDataset
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.synthetic import (
    SYNTHETIC_LABELS,
    SYNTHETIC_QUERIES,
    make_row,
)
from torch_parity import TINY, jax_imagebert_b_params

REPO = Path(__file__).resolve().parents[1]
ENV = {"KMR_CONFIG_OVERRIDES": json.dumps(TINY),
       "KMR_TOWER_CONFIG_OVERRIDES": json.dumps({"bert": TINY, "embed_dim": 16, "temperature": 0.1})}
F16_ULP = 2.0**-10  # relative: one float16 rounding step, at most


@pytest.fixture(autouse=True)
def _tiny_models(monkeypatch):
    for key, value in ENV.items():
        monkeypatch.setenv(key, value)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """32 distinct queries, one product each (unique texts: no false negatives in the batches)."""
    d = tmp_path_factory.mktemp("cascade")
    rng = np.random.default_rng(7)
    rows, answers = [], {}
    for i in range(32):
        qid, pid = i, 500000 + i
        query = f"{SYNTHETIC_QUERIES[i % len(SYNTHETIC_QUERIES)]} style {i}"
        rows.append(make_row(rng, product_id=pid, query_id=qid, query=query))
        answers[str(qid)] = [pid]
    (d / "pairs.tsv").write_text("\n".join(rows) + "\n")
    (d / "answers.json").write_text(json.dumps(answers))
    (d / "labels.txt").write_text("\n".join(f"{k}\t{v}" for k, v in SYNTHETIC_LABELS.items()) + "\n")
    save_npz(d / "cross_b.npz", jax_imagebert_b_params(JaxBertConfig(**TINY), 21))
    return d


@pytest.fixture(scope="module")
def tower_run(data_dir, tmp_path_factory):
    """80 steps of cli/train.py --model two_tower, with a valid pass at the end."""
    out = tmp_path_factory.mktemp("tower_run")
    with pytest.MonkeyPatch.context() as mp:
        for key, value in ENV.items():
            mp.setenv(key, value)
        _, state, report = train_cli.run([
            "--model", "two_tower", "--train-tsv", str(data_dir / "pairs.tsv"), "--labels",
            str(data_dir / "labels.txt"), "--steps", "80", "--batch-size", "16", "--lr", "1e-3",
            "--warmup-steps", "0", "--checkpoint-every", "80", "--out", str(out), "--valid-tsv",
            str(data_dir / "pairs.tsv"), "--answers", str(data_dir / "answers.json"), "--device", "cpu"])
    assert report["steps"] == state.step == 80 and report["data"] == "positive rows"
    return out


def _jax_script(name: str, argv: list[str], capsys) -> str:
    """``scripts/<name>.py`` run in this process (JAX on the CPU) -> the last line of its stdout."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    capsys.readouterr()
    old = sys.argv
    sys.argv = [f"{name}.py", *argv]
    try:
        module.main()
    finally:
        sys.argv = old
    return capsys.readouterr().out.strip().splitlines()[-1]


def _last_line(capsys) -> str:
    return capsys.readouterr().out.strip().splitlines()[-1]


def test_tower_training_learns(tower_run):
    metrics = [json.loads(line) for line in (tower_run / "metrics.jsonl").read_text().splitlines()]
    losses = [m["loss"] for m in metrics if "loss" in m]
    accs = [m["in_batch_accuracy"] for m in metrics if "in_batch_accuracy" in m]
    ndcgs = [m["valid_ndcg5"] for m in metrics if "valid_ndcg5" in m]
    assert len(losses) >= 2 and np.isfinite(losses).all()
    # 80 steps over 32 distinct rows: in-batch retrieval well past the 1/16 of chance
    assert losses[-1] < losses[0] and accs[-1] > 0.5, accs
    assert ndcgs and 0.0 <= ndcgs[-1] <= 1.0 and (tower_run / "step_80.npz").exists()


@pytest.mark.parametrize("packed", [False, True], ids=["npz", "packed"])
def test_recall_cli_matches_jax_script(data_dir, tower_run, tmp_path, packed, capsys):
    ckpt = str(tower_run / "step_80.npz")
    common = ["--tsv", str(data_dir / "pairs.tsv"), "--labels", str(data_dir / "labels.txt"), "--checkpoint", ckpt]
    extra = ["--packed", "--store-features", "--shard-size", "10"] if packed else []
    cats = {side: tmp_path / (f"{side}_cat" if packed else f"{side}_cat.npz") for side in ("port", "jax")}
    recall_cli.main(["build", *common, "--out", str(cats["port"]), *extra, "--device", "cpu"])
    _jax_script("recall", ["build", *common, "--out", str(cats["jax"]), *extra], capsys)
    if packed:
        port, jax_ = CatalogDataset(cats["port"]), CatalogDataset(cats["jax"])
        assert port.manifest == jax_.manifest
        got, want = port.rows(np.arange(len(port))), jax_.rows(np.arange(len(jax_)))
        for key in got:
            if key != "embedding":
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        got, want = got["embedding"], want["embedding"]
    else:
        with np.load(cats["port"]) as p, np.load(cats["jax"]) as j:
            np.testing.assert_array_equal(p["product_ids"], j["product_ids"])
            got, want = p["catalog"], j["catalog"]
    assert got.dtype == want.dtype == np.float16 and got.shape == want.shape == (32, 16)
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), atol=1e-5, rtol=F16_ULP)

    for side in ("port", "jax"):
        q_argv = ["query", *common, "--catalog", str(cats[side]), "--out", str(tmp_path / f"{side}_recall.tsv"),
                  "--k", "3", "--chunk-rows", "13"]
        recall_cli.main([*q_argv, "--device", "cpu"]) if side == "port" else _jax_script("recall", q_argv, capsys)
    assert (tmp_path / "port_recall.tsv").read_text() == (tmp_path / "jax_recall.tsv").read_text()
    assert len((tmp_path / "port_recall.tsv").read_text().splitlines()) == 32

    c_argv = ["curve", *common, "--catalog", str(cats["port"]), "--answers", str(data_dir / "answers.json"),
              "--ks", "1,5,20"]
    recall_cli.main([*c_argv, "--device", "cpu"])
    port_line = _last_line(capsys)
    assert port_line == _jax_script("recall", c_argv, capsys)
    assert json.loads(port_line)["recall_at_k"]["20"] >= json.loads(port_line)["recall_at_k"]["1"]


@pytest.mark.parametrize("catalog,k", [("tsv", 40), ("packed", 40), ("tsv", 5)], ids=["tsv", "packed", "narrow"])
def test_cascade_cli_matches_jax_script(data_dir, tower_run, tmp_path, catalog, k, capsys):
    """k=40 covers the 32-product catalog (recall@K 1.0); k=5 must beat the 5/32 of chance."""
    ckpt = str(tower_run / "step_80.npz")
    cat = str(data_dir / "pairs.tsv")
    if catalog == "packed":
        cat = str(tmp_path / "cat")
        recall_cli.main(["build", "--tsv", str(data_dir / "pairs.tsv"), "--labels", str(data_dir / "labels.txt"),
                         "--checkpoint", ckpt, "--out", cat, "--packed", "--store-features", "--shard-size", "10",
                         "--device", "cpu"])
    argv = ["--queries", str(data_dir / "pairs.tsv"), "--catalog", cat, "--labels", str(data_dir / "labels.txt"),
            "--tower-checkpoint", ckpt, "--cross-model", "imagebert_b", "--cross-checkpoint",
            str(data_dir / "cross_b.npz"), "--k-recall", str(k), "--chunk-rows", "13", "--answers",
            str(data_dir / "answers.json"), "--batch-size", "16", "--precision", "f32"]
    report = cascade_cli.main([*argv, "--out", str(tmp_path / "port.csv"), "--device", "cpu"])
    port_line = _last_line(capsys)
    jax_line = _jax_script("cascade", [*argv, "--out", str(tmp_path / "jax.csv")], capsys)
    assert port_line == jax_line
    rows = (tmp_path / "port.csv").read_text()
    assert rows == (tmp_path / "jax.csv").read_text()
    metrics = json.loads(port_line)
    assert metrics["k"] == min(k, 32) and 0.0 <= metrics["cascade_ndcg5"] <= 1.0
    assert metrics["recall_at_k"] == 1.0 if k == 40 else metrics["recall_at_k"] > 0.4
    lines = rows.splitlines()
    assert lines[0].startswith("query-id,product1") and len(lines) == 33
    assert report["pairs"] == 32 * min(k, 32) and sum(len(r) for r in report["scores"].values()) == report["pairs"]
    for line in lines[1:]:
        cells = line.split(",")
        assert len(cells) == 6 and all(500000 <= int(p) < 500032 for p in cells[1:] if p)


NEW_MODULES = ["models.two_tower", "data.catalog", "cli.recall", "cli.cascade", "cli.bench_recall_3m",
               "cli.train", "cli.export", "serving.export", "train.trainer", "parallel.engine"]


def test_no_module_of_the_slice_imports_jax():
    """The modules this slice adds or changes, and chip_smoke.py, imported in a
    fresh interpreter where ``jax`` and the JAX package cannot be imported."""
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'kddcup_2020_multimodalitiesrecall_2nd_place_tpu'):\n"
            "    sys.modules[name] = None\n"
            f"sys.path[:0] = [{str(REPO)!r}]\n"
            "import importlib\n"
            f"for m in {NEW_MODULES!r}:\n"
            "    importlib.import_module('kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.' + m)\n"
            "import chip_smoke\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-3000:]
