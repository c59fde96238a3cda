"""The rest of the port's training CLI on the CPU at a tiny config:
``cli/train.py --packed-dir``, the valid loop with ``best.npz``, ``--resume``,
``--grad-summaries``, and the scoring entry points on a tree that carries the
MLM head.

* The valid loop: ``--valid-tsv --valid-every 1`` logs at each step the
  ``valid_ndcg5`` that ``eval.evaluate_scores`` gives ``cli/score.py``'s
  scores of that step's checkpoint, exactly; ``best_metadata.json`` holds
  the max; ``best.npz`` scores through the JAX package's ``apply`` within
  1e-4 of the port (f32).
* A valid pass between two steps leaves training bit-equal (dropout on).
* Resume: k steps, then ``--resume state_<k>.npz`` for N-k more, is bit-equal
  to N straight steps (params, moments, EMA shadows, the checkpoint), for A
  on ``--packed-dir`` and B on ``--train-tsv``; and the resumed step k+1
  (dropout off) matches the JAX ``Trainer``'s straight step k+1 on the same
  packed batches: the loss within 1e-5, every gradient within 1e-4.
* A checkpoint with ``cls/predictions`` scores and exports as one without it.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu import data as jax_data
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import Precision as JaxPrecision
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import get_model as jax_get_model
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.parallel import make_mesh
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.train import Trainer as JaxTrainer
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.train import recipe_for as jax_recipe_for
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch import VOCAB_PATH
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import load_npz, params_from_jax, params_to_jax
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import save_npz
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import build_packed
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import score as score_cli
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import train as train_cli
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import Featurizer, PackedDataset
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import batches_from_files, load_multimodal_labels
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.synthetic import (
    SYNTHETIC_LABELS,
    SYNTHETIC_QUERIES,
    make_eval_tsv,
    make_tsv,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ensemble import load_tsv_scores
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.eval import evaluate_scores, load_answers
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import Precision, get_model
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.parallel import ScoringEngine
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.serving import export_scorer
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.tokenization import FullTokenizer
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.train import Trainer
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.train.optim import flatten_paths
from torch_parity import TINY

A_INPUTS = ("input_ids", "segment_ids", "features", "label_ids")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("rest")
    (d / "train.tsv").write_text("\n".join(make_tsv(40, seed=3)) + "\n")
    (d / "labels.txt").write_text("\n".join(f"{k}\t{v}" for k, v in SYNTHETIC_LABELS.items()) + "\n")
    (d / "query_labels.txt").write_text(
        "\n".join(f"{300000 + i}\t{q}\tdress,others" for i, q in enumerate(SYNTHETIC_QUERIES)) + "\n")
    lines, answers = make_eval_tsv(40, seed=4)
    (d / "valid.tsv").write_text("\n".join(lines) + "\n")
    (d / "answers.json").write_text(json.dumps(answers))
    return d


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setenv("KMR_CONFIG_OVERRIDES", json.dumps(TINY))


def _packed(files, out, model="imagebert_a"):
    build_packed.main(["--model", model, "--train-tsv", str(files / "train.tsv"), "--labels",
                       str(files / "labels.txt"), "--query-labels", str(files / "query_labels.txt"), "--out",
                       str(out), "--shard-size", "16"])
    return out


def _argv(files, out, *extra, model="imagebert_a", steps=2):
    return ["--model", model, "--labels", str(files / "labels.txt"), "--steps", str(steps), "--batch-size", "8",
            "--out", str(out), "--device", "cpu", *extra]


def _tsv(files):
    return ["--train-tsv", str(files / "train.tsv"), "--query-labels", str(files / "query_labels.txt")]


def _valid(files):
    return ["--valid-tsv", str(files / "valid.tsv"), "--answers", str(files / "answers.json")]


def test_valid_loop_matches_score_cli(files, tiny, tmp_path):
    packed = _packed(files, tmp_path / "packed")
    out = tmp_path / "run"
    _, state, report = train_cli.run(_argv(files, out, "--packed-dir", str(packed), "--mlm-weight", "0.5",
                                           "--grad-summaries", *_valid(files), "--valid-every", "1",
                                           "--checkpoint-every", "1", steps=3))
    lines = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    valid = {m["step"]: m["valid_ndcg5"] for m in lines if "valid_ndcg5" in m}
    assert sorted(valid) == [1, 2, 3] and report["data"] == "packed" and state.step == 3
    train_line = next(m for m in lines if "loss" in m)
    assert "mlm_loss" in train_line and "grad_norm_pre_clip/bert/encoder" in train_line
    assert "grad_norm_post_clip/cls/predictions" in train_line
    answers = load_answers(files / "answers.json")
    for step, ndcg in valid.items():
        scores = tmp_path / f"scores_{step}.tsv"
        score_cli.main(["--model", "imagebert_a", "--tsv", str(files / "valid.tsv"), "--labels",
                        str(files / "labels.txt"), "--checkpoint", str(out / f"step_{step}.npz"), "--out",
                        str(scores), "--device", "cpu", "--batch-size", "8"])
        assert evaluate_scores(load_tsv_scores(scores), answers) == ndcg, step
        assert (out / f"state_{step}.npz").exists()
    best = json.loads((out / "best_metadata.json").read_text())
    assert best["valid_ndcg5"] == max(valid.values()) and valid[best["step"]] == best["valid_ndcg5"]

    # best.npz (the MLM head included) through the JAX package's apply, against the port's engine
    tree = load_npz(out / "best.npz")
    assert "predictions" in tree["cls"]
    spec = get_model("imagebert_a")
    featurizer = Featurizer(FullTokenizer.google_style(VOCAB_PATH), load_multimodal_labels(files / "labels.txt"))
    batch = next(iter(batches_from_files([files / "valid.tsv"], featurizer.imagebert_a, 16, prefetch=0)))
    engine = ScoringEngine(spec, spec.from_jax(params_from_jax(tree)), device="cpu", precision=Precision.f32())
    with torch.inference_mode():
        port_scores = engine.score_batch(batch).numpy()
    jspec = jax_get_model("imagebert_a")
    jax_scores = jspec.apply(tree, {k: batch[k] for k in A_INPUTS}, jspec.config, JaxPrecision.f32())["score"]
    np.testing.assert_allclose(port_scores, np.asarray(jax_scores), atol=1e-4)


def _states_equal(a, b) -> None:
    with np.load(a) as fa, np.load(b) as fb:
        assert sorted(fa.files) == sorted(fb.files)
        for k in fa.files:
            assert np.array_equal(fa[k], fb[k]), k


def test_valid_pass_leaves_training_bit_equal(files, tiny, tmp_path):
    packed = _packed(files, tmp_path / "packed", "imagebert_b")
    base = ["--packed-dir", str(packed), "--word-match-weight", "0.5"]
    _, with_valid, _ = train_cli.run(_argv(files, tmp_path / "v", *base, *_valid(files), "--valid-every", "1",
                                           model="imagebert_b", steps=3))
    _, without, _ = train_cli.run(_argv(files, tmp_path / "n", *base, model="imagebert_b", steps=3))
    assert "kdd_query_match/kdd/kernel" in with_valid.optimizer.names
    for a, b in zip(with_valid.leaves(), without.leaves(), strict=True):
        assert torch.equal(a, b)
    _states_equal(tmp_path / "v" / "state_3.npz", tmp_path / "n" / "state_3.npz")


@pytest.mark.parametrize("model,source", [("imagebert_a", "packed"), ("imagebert_b", "tsv")])
def test_resume_equals_straight_run(files, tiny, tmp_path, model, source):
    extra = ["--packed-dir", str(_packed(files, tmp_path / "packed"))] if source == "packed" else _tsv(files)
    if model == "imagebert_b":
        extra += ["--word-match-weight", "0.5"]
    else:
        extra += ["--mlm-weight", "0.5"]
    _, straight, _ = train_cli.run(_argv(files, tmp_path / "straight", *extra, model=model, steps=4))
    train_cli.run(_argv(files, tmp_path / "split", *extra, model=model, steps=2))
    _, resumed, report = train_cli.run(_argv(files, tmp_path / "split", *extra, "--resume",
                                             str(tmp_path / "split" / "state_2.npz"), model=model, steps=2))
    assert (report["steps"], report["step"], resumed.step) == (2, 4, 4)
    for a, b in zip(straight.leaves(), resumed.leaves(), strict=True):
        assert torch.equal(a, b)
    _states_equal(tmp_path / "straight" / "state_4.npz", tmp_path / "split" / "state_4.npz")
    _states_equal(tmp_path / "straight" / "step_4.npz", tmp_path / "split" / "step_4.npz")


def test_load_state_raises_on_another_model_or_shape(files, tmp_path, monkeypatch):
    monkeypatch.setenv("KMR_CONFIG_OVERRIDES", json.dumps(TINY))
    a = Trainer(get_model("imagebert_a"), device="cpu")
    a.save_state(a.init_state(seed=0), tmp_path / "a.npz")
    b = Trainer(get_model("imagebert_b"), device="cpu")
    with pytest.raises(ValueError, match="imagebert_a train state"):
        b.load_state(b.init_state(seed=0), tmp_path / "a.npz")
    wide = Trainer(get_model("imagebert_a", overrides={"intermediate_size": 41}), device="cpu")
    with pytest.raises(ValueError, match="shapes differ"):
        wide.load_state(wide.init_state(seed=0), tmp_path / "a.npz")


@pytest.mark.parametrize("change", [{"optimizer": "adam_staircase"}, {"mlm_loss_weight": 0.5},
                                    {"num_train_steps": 999}, {"ema_decay": 0.997}])
def test_load_state_raises_on_another_train_config(tmp_path, monkeypatch, change):
    """A state resumes only under the config it was trained with; the
    ``grad_summaries`` switch alone may differ."""
    monkeypatch.setenv("KMR_CONFIG_OVERRIDES", json.dumps(TINY))
    spec = get_model("imagebert_a")
    saved = Trainer(spec, device="cpu")
    saved.save_state(saved.init_state(seed=0), tmp_path / "a.npz")
    logging = Trainer(spec, dataclasses.replace(saved.tc, grad_summaries=True), device="cpu")
    assert logging.load_state(logging.init_state(seed=0), tmp_path / "a.npz").step == 0
    other = Trainer(spec, dataclasses.replace(saved.tc, **change), device="cpu")
    with pytest.raises(ValueError, match=f"another train config: {next(iter(change))} "):
        other.load_state(other.init_state(seed=0), tmp_path / "a.npz")


def test_resumed_step_matches_jax_straight_step(files, tmp_path, monkeypatch):
    """Dropout off: the port's step 3 after ``--resume state_2.npz`` against the
    JAX Trainer's third straight step on the same packed batches, from the same
    initial tree."""
    monkeypatch.setenv("KMR_CONFIG_OVERRIDES", json.dumps({**TINY, "hidden_dropout_prob": 0.0,
                                                           "attention_probs_dropout_prob": 0.0}))
    packed = _packed(files, tmp_path / "packed")
    lr = ["--lr", "1e-5", "--warmup-steps", "0", "--total-steps", "1000"]
    trainer, _, _ = train_cli.run(_argv(files, tmp_path / "run", "--packed-dir", str(packed), *lr, steps=2))
    state = trainer.load_state(trainer.init_state(seed=0), tmp_path / "run" / "state_2.npz")
    batch3 = next(PackedDataset(packed).batches(8, epochs=None, seed=0, skip=2))
    grads, metrics = trainer.grads(state, trainer.to_device(batch3), seed=train_cli.step_seed(0, state.step))

    spec = jax_get_model("imagebert_a")
    jtc = dataclasses.replace(jax_recipe_for("imagebert_a"), learning_rate=trainer.tc.learning_rate,
                              num_warmup_steps=0, num_train_steps=trainer.tc.num_train_steps)
    jtrainer = JaxTrainer(spec, jtc, mesh=make_mesh(), precision=JaxPrecision.f32())
    jstate = jtrainer.init_state(jax.random.key(0))
    params = jax.device_put(jax.tree.map(jnp.asarray, params_to_jax(get_model("imagebert_a").init_params(0))),
                            jtrainer._replicated)
    jstate = jstate._replace(params=params, opt_state=jtrainer.tx.init(params))
    jbatches = jax_data.PackedDataset(packed).batches(8, epochs=None, seed=0)
    for _ in range(2):
        batch = {k: v for k, v in next(jbatches).items() if not k.startswith("masked_lm")}
        jstate, _ = jtrainer.train_step(jstate, batch, None)
    batch = {k: v for k, v in next(jbatches).items() if not k.startswith("masked_lm")}
    (loss, _), jgrads = jax.jit(jax.value_and_grad(jtrainer._loss_fn, has_aux=True))(jstate.params, batch, None)
    assert metrics["loss"].item() == pytest.approx(float(loss), abs=1e-5)
    want = flatten_paths(params_from_jax(jax.tree.map(np.asarray, jgrads)))
    for name, g in zip(state.optimizer.names, grads, strict=True):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-4, rtol=1e-4, err_msg=name)


def test_scoring_and_export_ignore_the_mlm_head(files, tiny, tmp_path):
    spec = get_model("imagebert_a")
    with_head = params_to_jax(spec.init_params(0))
    without = {**with_head, "cls": {"seq_relationship": with_head["cls"]["seq_relationship"]}}
    scores = {}
    for name, tree in (("with", with_head), ("without", without)):
        save_npz(tmp_path / f"{name}.npz", tree)
        score_cli.main(["--model", "imagebert_a", "--tsv", str(files / "valid.tsv"), "--labels",
                        str(files / "labels.txt"), "--checkpoint", str(tmp_path / f"{name}.npz"), "--out",
                        str(tmp_path / f"{name}.tsv"), "--device", "cpu"])
        scores[name] = (tmp_path / f"{name}.tsv").read_text()
    assert scores["with"] == scores["without"] and len(scores["with"].splitlines()) == 40
    exported = {name: export_scorer(spec, params_from_jax(tree), 4, Precision.f32(), "xla", "cpu")
                for name, tree in (("with", with_head), ("without", without))}
    keys = [sorted(e.state_dict) for e in exported.values()]
    assert keys[0] == keys[1] and not any("predictions" in k for k in keys[0])


def test_flag_conflicts_exit_2(files, tiny, tmp_path, capsys):
    for extra, message in ((["--packed-dir", "x", *_tsv(files)], "exactly one"), ([], "exactly one"),
                           ([*_tsv(files), "--valid-tsv", "v.tsv"], "together")):
        with pytest.raises(SystemExit) as e:
            train_cli.run(_argv(files, tmp_path / "run", *extra))
        assert e.value.code == 2 and message in capsys.readouterr().err


def test_packed_shards_of_another_model_raise(files, tiny, tmp_path):
    packed = _packed(files, tmp_path / "packed")  # A's sampler: no len_query / num_boxes
    with pytest.raises(ValueError, match="len_query"):
        train_cli.run(_argv(files, tmp_path / "run", "--packed-dir", str(packed), model="imagebert_b"))
