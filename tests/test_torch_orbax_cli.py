"""The port's entry points on the JAX package's orbax directories, on the CPU.

Tiny trees (``KMR_CONFIG_OVERRIDES`` = TINY at dropout 0; the two-tower with
``KMR_TOWER_CONFIG_OVERRIDES``), each written twice: by the JAX package's
``save_pytree`` (jax.Array leaves, as ``scripts/train.py`` writes
``step_<N>``) and by its ``save_npz``. Every entry point that takes a
checkpoint gives on the directory what it gives on the npz, bit for bit:

* ``cli/score.py`` for A, B, C and LXMERT (the score files equal), and held
  to ``scripts/score.py`` on the same directory within 1e-4 a pair with the
  same nDCG@5;
* ``cli/recall.py build`` with a tower directory (the catalog equal);
* ``cli/train.py --init-from <dir> --distill-from <dir>`` (``step_2.npz``
  equal);
* ``cli/export.py --checkpoint <dir>`` (the artifacts score a batch equally);
* ``cli/distill.py --teacher-checkpoint <dir> --init-from-teacher``
  (``student_final.npz`` equal).
"""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.checkpoint import save_npz, save_pytree
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import get_model as jax_get_model
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import two_tower as jax_two_tower
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import distill as distill_cli
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import export as export_cli
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import recall as recall_cli
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import score as score_cli
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import train as train_cli
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.batchspec import example_batch
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.synthetic import (
    SYNTHETIC_LABELS,
    SYNTHETIC_QUERIES,
    make_eval_tsv,
    make_tsv,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ensemble import load_csv_scores, load_tsv_scores
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import get_model
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.serving import load_scorer
from torch_parity import TINY, jax_imagebert_a_params, jax_imagebert_b_params, numpy_like

REPO = Path(__file__).resolve().parents[1]
NO_DROPOUT = {**TINY, "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}
ENV = {"KMR_CONFIG_OVERRIDES": json.dumps(NO_DROPOUT),
       "KMR_TOWER_CONFIG_OVERRIDES": json.dumps({"bert": TINY, "embed_dim": 16})}


@pytest.fixture(autouse=True)
def _tiny_models(monkeypatch):
    for key, value in ENV.items():
        monkeypatch.setenv(key, value)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The data files, and each model's tree as an orbax directory and an npz: A, B (with am_kernel;
    C reads it too), LXMERT at its default depths and the two-tower."""
    d = tmp_path_factory.mktemp("orbax_cli")
    with pytest.MonkeyPatch.context() as mp:
        for key, value in ENV.items():
            mp.setenv(key, value)
        b = jax_imagebert_b_params(jax_get_model("imagebert_b").config, 32)
        b["cls"]["seq_relationship"]["am_kernel"] = np.random.default_rng(33).standard_normal(
            (TINY["hidden_size"], 2)).astype(np.float32)
        tower_cfg = jax_two_tower.two_tower_config()
        trees = {"imagebert_a": jax_imagebert_a_params(jax_get_model("imagebert_a").config, 31), "imagebert_b": b,
                 "lxmert": numpy_like(jax.eval_shape(
                     lambda: jax_get_model("lxmert").init_params(jax.random.key(0))), 34),
                 "two_tower": numpy_like(jax.eval_shape(
                     lambda: jax_two_tower.init_params(jax.random.key(0), tower_cfg)), 35)}
    for name, tree in trees.items():
        save_pytree(d / name, jax.tree.map(jnp.asarray, tree))
        save_npz(d / f"{name}.npz", tree)
    (d / "pairs.tsv").write_text("\n".join(make_tsv(24, seed=36)) + "\n")
    (d / "labels.txt").write_text("".join(f"{k}\t{v}\n" for k, v in SYNTHETIC_LABELS.items()))
    (d / "query_labels.txt").write_text(
        "".join(f"{300000 + i}\t{q}\tdress,others\n" for i, q in enumerate(SYNTHETIC_QUERIES)))
    lines, answers = make_eval_tsv(48, seed=37)
    (d / "valid.tsv").write_text("\n".join(lines) + "\n")
    (d / "answers.json").write_text(json.dumps(answers))
    return d


def _jax_score(argv: list[str], monkeypatch) -> None:
    spec = importlib.util.spec_from_file_location("jax_script_score", REPO / "scripts" / "score.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(sys, "argv", ["score.py", *argv])
    module.main()


@pytest.mark.parametrize("model", ["imagebert_a", "imagebert_b", "imagebert_c", "lxmert"])
def test_score_cli_on_a_directory(files, model, monkeypatch, capsys):
    d = files
    tree = "imagebert_b" if model == "imagebert_c" else model
    suffix = ".csv" if model == "lxmert" else ".tsv"
    common = ["--model", model, "--tsv", str(d / "valid.tsv"), "--labels", str(d / "labels.txt"),
              "--answers", str(d / "answers.json"), "--batch-size", "16"]
    ndcg = {}
    for source, ckpt in (("dir", d / tree), ("npz", d / f"{tree}.npz")):
        score_cli.main([*common, "--checkpoint", str(ckpt), "--out", str(d / f"{model}_{source}{suffix}"),
                        "--device", "cpu"])
        ndcg[source] = json.loads(capsys.readouterr().out.splitlines()[-2])["ndcg_at_5"]
    assert (d / f"{model}_dir{suffix}").read_bytes() == (d / f"{model}_npz{suffix}").read_bytes()
    _jax_score([*common, "--checkpoint", str(d / tree), "--out", str(d / f"{model}_jax{suffix}")], monkeypatch)
    jax_ndcg = json.loads(capsys.readouterr().out.splitlines()[-2])["ndcg_at_5"]
    load = load_tsv_scores if suffix == ".tsv" else load_csv_scores
    got, want = load(d / f"{model}_dir{suffix}"), load(d / f"{model}_jax{suffix}")
    assert got.keys() == want.keys() and sum(map(len, got.values())) == 48
    for q in want:
        assert got[q].keys() == want[q].keys()
        np.testing.assert_allclose([got[q][p] for p in want[q]], list(want[q].values()), atol=1e-4, rtol=0)
    assert ndcg["dir"] == ndcg["npz"] == jax_ndcg


def test_recall_build_on_a_tower_directory(files):
    d = files
    common = ["build", "--tsv", str(d / "pairs.tsv"), "--labels", str(d / "labels.txt"), "--device", "cpu"]
    for source in ("two_tower", "two_tower.npz"):
        recall_cli.main([*common, "--checkpoint", str(d / source), "--out", str(d / f"cat_{source}.npz")])
    with np.load(d / "cat_two_tower.npz") as got, np.load(d / "cat_two_tower.npz.npz") as want:
        assert got.files == want.files
        for k in want.files:
            assert got[k].tobytes() == want[k].tobytes(), k


def _same_npz(a: Path, b: Path) -> None:
    with np.load(a) as got, np.load(b) as want:
        assert got.files == want.files
        for k in want.files:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


def test_train_init_from_and_distill_from_a_directory(files):
    d = files
    for source in ("imagebert_a", "imagebert_a.npz"):
        train_cli.run(["--model", "imagebert_a", "--train-tsv", str(d / "pairs.tsv"), "--labels",
                       str(d / "labels.txt"), "--query-labels", str(d / "query_labels.txt"), "--steps", "2",
                       "--batch-size", "8", "--layers", "1", "--init-from", str(d / source), "--distill-from",
                       str(d / source), "--checkpoint-every", "2", "--out", str(d / f"train_{source}"),
                       "--device", "cpu"])
    _same_npz(d / "train_imagebert_a" / "step_2.npz", d / "train_imagebert_a.npz" / "step_2.npz")


def test_export_on_a_directory(files):
    d = files
    for source in ("imagebert_b", "imagebert_b.npz"):
        export_cli.main(["--model", "imagebert_b", "--checkpoint", str(d / source), "--batch-size", "4",
                         "--precision", "f32", "--device", "cpu", "--out", str(d / f"art_{source}")])
    spec = get_model("imagebert_b")
    batch = example_batch("imagebert_b", spec.config, 4, np.random.default_rng(38))
    got = np.asarray(load_scorer(d / "art_imagebert_b")(batch))
    want = np.asarray(load_scorer(d / "art_imagebert_b.npz")(batch))
    assert got.tobytes() == want.tobytes()


def test_distill_teacher_from_a_directory(files):
    d = files
    for source in ("imagebert_b", "imagebert_b.npz"):
        distill_cli.main(["--model", "imagebert_b", "--student-layers", "1", "--tsv", str(d / "pairs.tsv"),
                          "--labels", str(d / "labels.txt"), "--teacher-checkpoint", str(d / source),
                          "--init-from-teacher", "--steps", "2", "--batch-size", "8", "--lr", "1e-3",
                          "--warmup-steps", "1", "--out", str(d / f"distill_{source}"), "--device", "cpu"])
    _same_npz(d / "distill_imagebert_b" / "student_final.npz", d / "distill_imagebert_b.npz" / "student_final.npz")
