"""The port's train CLI on the CPU at a tiny ImageBERT-A and ImageBERT-B/C:
two steps write ``metrics.jsonl`` and ``step_2.npz`` in the JAX package's
param tree (B's label conv as its taps, the EMA shadows); that checkpoint
scores through the port's ``cli/score.py`` exactly as the trained params in
memory do, and through the JAX package's ``apply`` within 1e-4; the device
policy and the models and flags that are not ported (exit 2)."""

import json

import jax
import numpy as np
import pytest
import torch

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import Precision as JaxPrecision
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import get_model as jax_get_model
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch import VOCAB_PATH
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import load_npz
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import score as score_cli
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import train as train_cli
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import Featurizer, load_multimodal_labels
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import batches_from_files
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.synthetic import (
    SYNTHETIC_LABELS,
    SYNTHETIC_QUERIES,
    make_tsv,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import Precision
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.parallel import ScoringEngine
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.tokenization import FullTokenizer
from torch_parity import TINY


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("KMR_CONFIG_OVERRIDES", json.dumps(TINY))
    (tmp_path / "train.tsv").write_text("\n".join(make_tsv(40, seed=3)) + "\n")
    (tmp_path / "labels.txt").write_text("\n".join(f"{k}\t{v}" for k, v in SYNTHETIC_LABELS.items()) + "\n")
    (tmp_path / "query_labels.txt").write_text(
        "\n".join(f"{300000 + i}\t{q}\tdress,others" for i, q in enumerate(SYNTHETIC_QUERIES)) + "\n")
    return tmp_path


def _argv(d, *extra):
    return ["--model", "imagebert_a", "--train-tsv", str(d / "train.tsv"), "--labels", str(d / "labels.txt"),
            "--query-labels", str(d / "query_labels.txt"), "--steps", "2", "--batch-size", "8",
            "--out", str(d / "run"), "--device", "cpu", *extra]


def test_train_cli_writes_metrics_and_checkpoint_that_score(data_dir, capsys):
    trainer, state, report = train_cli.run(_argv(data_dir, "--ms-weight", "0.5"))
    assert report["steps"] == state.step == 2 and report["pairs"] == 16
    lines = [json.loads(line) for line in (data_dir / "run" / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in lines] == [0]
    assert {"loss", "accuracy", "grad_norm"} <= lines[0].keys() and np.isfinite(lines[0]["loss"])
    ckpt = data_dir / "run" / "step_2.npz"
    tree = load_npz(ckpt)
    assert {"query", "key", "value", "output"} <= tree["bert"]["encoder"]["attention"].keys()

    # the checkpoint through cli/score.py vs the trained params in memory
    out = data_dir / "scores.tsv"
    score_cli.main(["--model", "imagebert_a", "--tsv", str(data_dir / "train.tsv"), "--labels",
                    str(data_dir / "labels.txt"), "--checkpoint", str(ckpt), "--out", str(out), "--device", "cpu"])
    got = {tuple(line.split("\t")[:2]): float(line.split("\t")[2]) for line in out.read_text().splitlines()}
    params = {k: v for k, v in trainer.eval_params(state).items()}
    engine = ScoringEngine(trainer.model, jax.tree.map(lambda t: t.detach().clone(), params), device="cpu",
                           precision=Precision.f32())
    featurizer = Featurizer(FullTokenizer.google_style(VOCAB_PATH), load_multimodal_labels(data_dir / "labels.txt"))
    want = engine.score_files([data_dir / "train.tsv"], featurizer, 16)
    assert len(got) == sum(len(r) for r in want.values()) > 0
    for (q, p), s in got.items():
        assert s == want[q][p]

    # and through the JAX package's apply
    spec = jax_get_model("imagebert_a")
    batch = next(iter(batches_from_files([data_dir / "train.tsv"], featurizer.imagebert_a, 16, prefetch=0)))
    jax_scores = np.asarray(spec.apply(tree, {k: batch[k] for k in ("input_ids", "segment_ids", "features",
                                                                     "label_ids")}, spec.config,
                                       JaxPrecision.f32())["score"])
    with torch.inference_mode():
        port_scores = engine.score_batch(batch).numpy()
    np.testing.assert_allclose(port_scores, jax_scores, atol=1e-4)


def test_train_cli_device_cuda_raises_without_a_gpu(data_dir):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.run(_argv(data_dir)[:-2] + ["--device", "cuda"])


@pytest.mark.parametrize("extra", [["--distributed"], ["--am-loss"]])
def test_unported_flags_exit_2(data_dir, extra, capsys):
    with pytest.raises(SystemExit) as e:
        train_cli.run(_argv(data_dir, *extra))
    assert e.value.code == 2 and "ROADMAP" in capsys.readouterr().err


@pytest.mark.parametrize("model", ["two_tower", "lxmert"])
def test_other_models_exit_2(data_dir, model, capsys):
    argv = _argv(data_dir)
    argv[1] = model
    with pytest.raises(SystemExit) as e:
        train_cli.run(argv)
    assert e.value.code == 2 and "ROADMAP" in capsys.readouterr().err


@pytest.mark.parametrize("model", ["imagebert_b", "imagebert_c"])
def test_train_cli_b_and_c_write_taps_that_score(data_dir, model):
    argv = _argv(data_dir, "--word-match-weight", "0.5") if model == "imagebert_b" else _argv(data_dir)
    argv[1] = model
    trainer, state, report = train_cli.run(argv)
    assert report["steps"] == state.step == 2 and state.ema is not None
    lines = [json.loads(line) for line in (data_dir / "run" / "metrics.jsonl").read_text().splitlines()]
    assert np.isfinite(lines[0]["loss"]) and ("word_match_loss" in lines[0]) == (model == "imagebert_b")
    ckpt = data_dir / "run" / "step_2.npz"
    tree = load_npz(ckpt)
    h = trainer.model.config.hidden_size
    assert tree["kdd_conv1"].keys() == {"weights", "biases"} and tree["kdd_conv1"]["weights"].shape == (8, h, h)
    assert ("kdd_query_match" in tree) == (model == "imagebert_b")

    # the checkpoint through cli/score.py vs the EMA shadows in memory, on the same batches (the AM head's
    # scale 30 turns another CPU blocking of a product into a last-bit difference of the score)
    out = data_dir / "scores.tsv"
    score_cli.main(["--model", model, "--tsv", str(data_dir / "train.tsv"), "--labels", str(data_dir / "labels.txt"),
                    "--checkpoint", str(ckpt), "--out", str(out), "--device", "cpu", "--batch-size", "16"])
    got = {tuple(line.split("\t")[:2]): float(line.split("\t")[2]) for line in out.read_text().splitlines()}
    engine = ScoringEngine(trainer.model, trainer.eval_params(state), device="cpu", precision=Precision.f32())
    featurizer = Featurizer(FullTokenizer.google_style(VOCAB_PATH), load_multimodal_labels(data_dir / "labels.txt"),
                            sen2forest=trainer.model.sen2forest)
    want = engine.score_files([data_dir / "train.tsv"], featurizer, 16)
    assert len(got) == sum(len(r) for r in want.values()) > 0
    for (q, p), s in got.items():
        assert s == want[q][p]

    # and through the JAX package's apply
    spec = jax_get_model(model)
    batch = next(iter(batches_from_files([data_dir / "train.tsv"], featurizer.imagebert_b, 16, prefetch=0)))
    keys = ("input_ids", "len_query", "num_boxes", "segment_ids", "boxes", "features", "label_ids", "labels")
    jax_scores = np.asarray(spec.apply(tree, {k: batch[k] for k in keys}, spec.config, JaxPrecision.f32())["score"])
    with torch.inference_mode():
        port_scores = engine.score_batch(batch).numpy()
    np.testing.assert_allclose(port_scores, jax_scores, atol=1e-4)
