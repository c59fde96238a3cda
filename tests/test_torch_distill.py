"""The port's distillation against the JAX package's ``train/distill.py`` and
``scripts/distill.py``, on the CPU at tiny widths.

``distill_soft_ce`` (with and without weights, at three temperatures) and
``teacher_logodds`` within 1e-6 of JAX; ``match_logodds`` of A, B, C and
LXMERT on the same pooled outputs and heads within 1e-5; the layer maps and
``init_student_from_teacher`` equal leaf for leaf (a shallower and a deeper
student, a mismatched width, a larger vocab, LXMERT's three stacks);
``TeacherScores`` (``from_files``, ``from_ensemble_files``, ``attach``'s
``KeyError``) equal; ``LiveTeacher``'s probabilities within 1e-5 of JAX's
``LiveTeacher`` in f32 (B's fed labels forced to 1); ``cli/distill.py
--device cpu`` (an offline and a live teacher) writing ``metrics.jsonl``
lines within 1e-5 of ``scripts/distill.py``'s over 2 steps (both in f32,
dropout 0, the student initialised from the teacher's layers on both sides);
``cli/train.py --layers/--init-from/--distill-from`` on the CPU; and
``score_fidelity.compare`` equal to JAX's.
"""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu import train as jax_train
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import Precision as JaxPrecision
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.models import get_model as jax_get_model
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.train import distill as jax_distill
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import (
    flatten_tree,
    load_npz,
    params_from_jax,
    params_to_jax,
    save_npz,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import distill as distill_cli
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import score as score_cli
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import score_fidelity
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import train as train_cli
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.synthetic import (
    SYNTHETIC_LABELS,
    SYNTHETIC_QUERIES,
    make_eval_tsv,
    make_tsv,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ensemble import load_tsv_scores
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import Precision, get_model
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.train import (
    LiveTeacher,
    TeacherScores,
    distill_soft_ce,
    evenly_spaced_layers,
    init_student_from_teacher,
    match_logodds,
    model_batch_of,
    stacking_layer_map,
    teacher_logodds,
)
from torch_parity import TINY, jax_imagebert_a_params, jax_imagebert_b_params, numpy_like

REPO = Path(__file__).resolve().parents[1]
NO_DROPOUT = {**TINY, "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}


def _jax_tree(name: str, seed: int, **overrides) -> dict:
    """Numpy params in the JAX layout for the JAX spec of ``name`` (KMR_CONFIG_OVERRIDES and ``overrides``)."""
    spec = jax_get_model(name, overrides=overrides or None)
    return numpy_like(jax.eval_shape(lambda: spec.init_params(jax.random.key(0))), seed)


# ---- the loss ----------------------------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [1.0, 2.0, 4.0])
@pytest.mark.parametrize("weighted", [False, True], ids=["mean", "weighted"])
def test_distill_soft_ce_matches_jax(temperature, weighted):
    rng = np.random.default_rng(1)
    s = (3.0 * rng.standard_normal(64)).astype(np.float32)
    p = rng.random(64).astype(np.float32)
    p[:4] = [0.0, 1.0, 1e-9, 1.0 - 1e-9]  # the clipped ends
    w = (rng.random(64) > 0.3).astype(np.float32) if weighted else None
    got = distill_soft_ce(torch.from_numpy(s), torch.from_numpy(p), temperature,
                          None if w is None else torch.from_numpy(w))
    want = jax_distill.distill_soft_ce(jnp.asarray(s), jnp.asarray(p), temperature,
                                       None if w is None else jnp.asarray(w))
    assert got.item() == pytest.approx(float(want), abs=1e-6)
    zero = distill_soft_ce(torch.from_numpy(s), torch.from_numpy(p), temperature, torch.zeros(64))
    assert zero.item() == pytest.approx(float(jax_distill.distill_soft_ce(jnp.asarray(s), jnp.asarray(p), temperature,
                                                                          jnp.zeros(64))), abs=1e-6)


def test_teacher_logodds_matches_jax():
    p = np.concatenate([np.linspace(0.0, 1.0, 101), [1e-8, 1 - 1e-8]]).astype(np.float32)
    np.testing.assert_allclose(teacher_logodds(torch.from_numpy(p)).numpy(),
                               np.asarray(jax_distill.teacher_logodds(jnp.asarray(p))), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", ["imagebert_a", "imagebert_b", "imagebert_c", "lxmert"])
def test_match_logodds_matches_jax(name, monkeypatch):
    monkeypatch.setenv("KMR_CONFIG_OVERRIDES", json.dumps(TINY))
    rng = np.random.default_rng(2)
    tree = _jax_tree(name, 3)
    if name in ("imagebert_b", "imagebert_c"):  # an am_kernel wide enough to push cos past the margin
        tree["cls"]["seq_relationship"]["am_kernel"] = rng.standard_normal((TINY["hidden_size"], 2)).astype(np.float32)
    pooled = rng.standard_normal((16, TINY["hidden_size"])).astype(np.float32)
    out = {"pooled": pooled, "logit": rng.standard_normal((16, 2)).astype(np.float32)}
    batch = {"labels": rng.integers(0, 2, 16).astype(np.int32)}  # ignored: the margin sits at label 1
    port_params = get_model(name).from_jax(params_from_jax(tree))
    got = match_logodds(name, port_params, {k: torch.from_numpy(v) for k, v in out.items()},
                        {k: torch.from_numpy(v) for k, v in batch.items()})
    want = jax_distill.match_logodds(name, jax.tree.map(jnp.asarray, tree),
                                     {k: jnp.asarray(v) for k, v in out.items()}, batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


# ---- the student's init ------------------------------------------------------------------------------

@pytest.mark.parametrize("n,m", [(1, 12), (4, 12), (6, 12), (5, 7), (12, 12), (3, 3)])
def test_layer_maps_match_jax(n, m):
    assert evenly_spaced_layers(n, m) == jax_distill.evenly_spaced_layers(n, m)
    assert stacking_layer_map(m, n) == jax_distill.stacking_layer_map(m, n)
    with pytest.raises(ValueError):
        evenly_spaced_layers(m + 1, m)
    with pytest.raises(ValueError):
        stacking_layer_map(n, n + 1)


@pytest.mark.parametrize("case", ["shallower", "deeper", "mismatched_width", "larger_vocab", "lxmert"])
def test_init_student_from_teacher_matches_jax(case, monkeypatch):
    monkeypatch.setenv("KMR_CONFIG_OVERRIDES", json.dumps(TINY))
    name = {"mismatched_width": "imagebert_b", "lxmert": "lxmert"}.get(case, "imagebert_a")
    teacher = _jax_tree(name, 4, **({"l_layers": 4, "x_layers": 3, "r_layers": 2} if case == "lxmert"
                                    else {"num_hidden_layers": 5}))
    student_overrides = {"shallower": {"num_hidden_layers": 2}, "deeper": {"num_hidden_layers": 11},
                         "mismatched_width": {"hidden_size": 16, "num_attention_heads": 2},
                         "larger_vocab": {"num_hidden_layers": 3, "vocab_size": 21200},
                         "lxmert": {"l_layers": 2, "x_layers": 3, "r_layers": 5}}[case]
    student = _jax_tree(name, 5, **student_overrides)
    got = flatten_tree(init_student_from_teacher(student, teacher))
    want = flatten_tree(jax.tree.map(np.asarray, jax_distill.init_student_from_teacher(student, teacher)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    s, t = flatten_tree(student), flatten_tree(teacher)
    copied = [k for k in want if np.array_equal(got[k], t[k])] if case != "mismatched_width" else []
    kept = [k for k in want if np.array_equal(got[k], s[k])]
    if case == "larger_vocab":  # the bigger table keeps its init; the rest comes from the teacher
        assert "bert/embeddings/word_embeddings" in kept and "bert/pooler/dense/kernel" in copied
    if case == "mismatched_width":  # only the leaves whose shapes do not depend on the width are the teacher's
        assert "bert/embeddings/word_embeddings" in kept and "bert/encoder/attention/query/kernel" in kept


def test_init_student_takes_the_port_trees_of_a_teacher_without_an_mlm_head(monkeypatch):
    """The port's trees (``params_to_jax``): a student with the MLM head and a teacher without one (an
    inference-only ImageBERT-A bundle) -> the head keeps the student's init, the rest is the teacher's; any
    other difference between the trees raises."""
    monkeypatch.setenv("KMR_CONFIG_OVERRIDES", json.dumps(TINY))
    spec = get_model("imagebert_a", overrides={"num_hidden_layers": 1})
    student = params_to_jax(spec.init_params(1))
    teacher = params_to_jax(get_model("imagebert_a").init_params(2))
    teacher["cls"] = {"seq_relationship": teacher["cls"]["seq_relationship"]}
    mapped = flatten_tree(init_student_from_teacher(student, teacher))
    np.testing.assert_array_equal(mapped["cls/predictions/output_bias"], student["cls"]["predictions"]["output_bias"])
    np.testing.assert_array_equal(mapped["bert/encoder/attention/query/kernel"][0],
                                  teacher["bert"]["encoder"]["attention"]["query"]["kernel"][1])
    del teacher["featureemb"]
    with pytest.raises(ValueError, match="featureemb"):
        init_student_from_teacher(student, teacher)


# ---- the teachers ---------------------------------------------------------------------------------------

def _score_file(path: Path, rows, fmt: str = "tsv") -> None:
    if fmt == "csv":
        path.write_text("query-id,product-id,score\n" + "".join(f"{q},{p},{s}\n" for q, p, s in rows))
    else:
        path.write_text("".join(f"{q}\t{p}\t{s}\n" for q, p, s in rows))


def test_teacher_scores_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    pairs = [(str(q), str(p)) for q in range(100, 104) for p in range(200, 206)]
    for i, name in enumerate(("b", "c", "a")):
        keep = pairs if i == 0 else [pq for j, pq in enumerate(pairs) if j % (i + 2)]  # C and A miss some pairs
        _score_file(tmp_path / f"{name}.txt", [(q, p, rng.random()) for q, p in keep])
    _score_file(tmp_path / "l.csv", [(q, p, rng.random()) for q, p in pairs], "csv")
    files = [str(tmp_path / f) for f in ("b.txt", "c.txt", "a.txt", "l.csv")]
    got = TeacherScores.from_ensemble_files(*files)
    want = jax_distill.TeacherScores.from_ensemble_files(*files)
    assert got.probs == want.probs and len(got) == len(pairs)
    weights = (0.1, 0.2, 0.3, 0.4)
    assert TeacherScores.from_ensemble_files(*files, weights=weights).probs == \
        jax_distill.TeacherScores.from_ensemble_files(*files, weights=weights).probs
    full = [files[0], files[3]]
    assert TeacherScores.from_files(full).probs == jax_distill.TeacherScores.from_files(full).probs
    assert TeacherScores.from_files(full, [0.7, 0.3]).probs == jax_distill.TeacherScores.from_files(full, [0.7, 0.3]).probs
    with pytest.raises(KeyError, match="missing from one of the teacher score files"):
        TeacherScores.from_files([files[0], files[1]])
    with pytest.raises(ValueError, match="one weight per score file"):
        TeacherScores.from_files(full, [1.0])

    batch = {"query_id": np.array([100, 101, 103, 0]), "product_id": np.array([200, 205, 201, 0]),
             "valid": np.array([True, True, True, False]), "input_ids": np.zeros((4, 3), np.int32)}
    a, b = got.attach(batch), want.attach(batch)
    for k in ("teacher_prob", "teacher_weight"):
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype == np.float32
    assert a["teacher_weight"].tolist() == [1, 1, 1, 0] and a["input_ids"] is batch["input_ids"]
    missing = {**batch, "product_id": np.array([200, 299, 201, 0])}
    with pytest.raises(KeyError, match="no teacher score"):
        got.attach(missing)
    assert model_batch_of(a).keys() == jax_distill.model_batch_of(b).keys() == {"input_ids"}


@pytest.mark.parametrize("name", ["imagebert_a", "imagebert_b", "lxmert"])
def test_live_teacher_matches_jax(name, monkeypatch):
    monkeypatch.setenv("KMR_CONFIG_OVERRIDES", json.dumps(TINY))
    rng = np.random.default_rng(7)
    tree = _jax_tree(name, 8, **({"l_layers": 2, "x_layers": 1, "r_layers": 1} if name == "lxmert" else {}))
    if name == "imagebert_b":
        tree["cls"]["seq_relationship"]["am_kernel"] = rng.standard_normal((TINY["hidden_size"], 2)).astype(np.float32)
    spec = get_model(name, overrides={"l_layers": 2, "x_layers": 1, "r_layers": 1} if name == "lxmert" else None)
    jspec = jax_get_model(name, overrides={"l_layers": 2, "x_layers": 1, "r_layers": 1} if name == "lxmert" else None)
    lines = make_tsv(16, seed=9)
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch import VOCAB_PATH
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import Featurizer
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.pipeline import iter_batches
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.tokenization import FullTokenizer

    tok = FullTokenizer.hf_style(VOCAB_PATH) if name == "lxmert" else FullTokenizer.google_style(VOCAB_PATH)
    fz = Featurizer(tok, {str(k): v for k, v in SYNTHETIC_LABELS.items()})
    batch = next(iter_batches(iter(lines), fz.for_model(name), 12))  # 12 rows of 15: a padded tail in the next
    batch["labels"] = rng.integers(0, 2, 12).astype(np.int32)  # a hard label, which the teacher overrides with 1
    batch["valid"][-2:] = False
    got = LiveTeacher(spec, spec.from_jax(params_from_jax(tree)), device="cpu", precision=Precision.f32()).attach(batch)
    want = jax_distill.LiveTeacher(jspec, jax.tree.map(jnp.asarray, tree), precision=JaxPrecision.f32()).attach(batch)
    assert isinstance(got["teacher_prob"], torch.Tensor) and got["teacher_prob"].dtype == torch.float32
    np.testing.assert_allclose(got["teacher_prob"].numpy(), want["teacher_prob"], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["teacher_weight"], want["teacher_weight"])
    assert np.array_equal(got["labels"], batch["labels"])  # the caller's batch keeps its labels
    if name == "imagebert_b":  # the fed label is 1, not the batch's
        flipped = LiveTeacher(spec, spec.from_jax(params_from_jax(tree)), device="cpu",
                              precision=Precision.f32()).attach({**batch, "labels": np.ones(12, np.int32)})
        assert torch.equal(flipped["teacher_prob"], got["teacher_prob"])
        torch.manual_seed(0)
        x = torch.randn(12, requires_grad=True)  # the teacher's output is saved by the loss's backward
        distill_soft_ce(x, got["teacher_prob"]).backward()
        assert x.grad is not None


# ---- the CLIs ---------------------------------------------------------------------------------------------

@pytest.fixture
def files(tmp_path, monkeypatch):
    """A tiny config with dropout 0, a TSV of pairs, labels, query labels, a planted valid set, the teachers'
    npz trees (5 layers) and an offline teacher's score file."""
    monkeypatch.setenv("KMR_CONFIG_OVERRIDES", json.dumps({**NO_DROPOUT, "num_hidden_layers": 5}))
    (tmp_path / "pairs.tsv").write_text("\n".join(make_tsv(24, seed=10)) + "\n")
    (tmp_path / "labels.txt").write_text("".join(f"{k}\t{v}\n" for k, v in SYNTHETIC_LABELS.items()))
    (tmp_path / "query_labels.txt").write_text(
        "".join(f"{300000 + i}\t{q}\tdress,others\n" for i, q in enumerate(SYNTHETIC_QUERIES)))
    lines, answers = make_eval_tsv(24, seed=11)
    (tmp_path / "valid.tsv").write_text("\n".join(lines) + "\n")
    (tmp_path / "answers.json").write_text(json.dumps(answers))
    save_npz(tmp_path / "a.npz", jax_imagebert_a_params(jax_get_model("imagebert_a").config, 12))
    b = jax_imagebert_b_params(jax_get_model("imagebert_b").config, 13)
    b["cls"]["seq_relationship"]["am_kernel"] = np.random.default_rng(14).standard_normal(
        (NO_DROPOUT["hidden_size"], 2)).astype(np.float32)
    save_npz(tmp_path / "b.npz", b)
    score_cli.main(["--model", "imagebert_a", "--tsv", str(tmp_path / "pairs.tsv"), "--labels",
                    str(tmp_path / "labels.txt"), "--checkpoint", str(tmp_path / "a.npz"), "--out",
                    str(tmp_path / "a_scores.txt"), "--device", "cpu"])
    return tmp_path


def _jax_distill(argv: list[str], monkeypatch) -> None:
    """The JAX package's scripts/distill.py in process, its Trainer and LiveTeacher in f32 (the script's
    defaults are bf16), as the port runs on the CPU."""

    class F32Trainer(jax_train.Trainer):
        def __init__(self, model, tc=None, mesh=None, precision=None):
            super().__init__(model, tc, mesh, JaxPrecision.f32())

    class F32LiveTeacher(jax_train.LiveTeacher):
        def __init__(self, spec, params, precision=None):
            super().__init__(spec, params, JaxPrecision.f32())

    monkeypatch.setattr(jax_train, "Trainer", F32Trainer)
    monkeypatch.setattr(jax_train, "LiveTeacher", F32LiveTeacher)
    monkeypatch.setattr(sys, "argv", ["distill.py", *argv])
    spec = importlib.util.spec_from_file_location("jax_script_distill", REPO / "scripts" / "distill.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.main()


def _metrics(path: Path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.mark.parametrize("teacher", ["offline", "live"])
def test_distill_cli_matches_jax_script(files, teacher, monkeypatch):
    d = files
    model = "imagebert_a" if teacher == "offline" else "imagebert_b"
    ckpt = str(d / ("a.npz" if model == "imagebert_a" else "b.npz"))
    argv = ["--model", model, "--student-layers", "2", "--tsv", str(d / "pairs.tsv"), "--labels",
            str(d / "labels.txt"), "--teacher-checkpoint", ckpt, "--init-from-teacher", "--steps", "2",
            "--batch-size", "8", "--lr", "1e-3", "--warmup-steps", "1", "--temperature", "2.0"]
    if teacher == "offline":
        argv += ["--teacher-scores", str(d / "a_scores.txt")]
    report = distill_cli.main([*argv, "--out", str(d / "port"), "--device", "cpu", "--valid-tsv",
                               str(d / "valid.tsv"), "--answers", str(d / "answers.json")])
    _jax_distill([*argv, "--out", str(d / "jax"), "--valid-tsv", str(d / "valid.tsv"), "--answers",
                  str(d / "answers.json")], monkeypatch)
    got, want = _metrics(d / "port" / "metrics.jsonl"), _metrics(d / "jax" / "metrics.jsonl")
    assert [sorted(m) for m in got] == [sorted(m) for m in want]
    assert any("distill_loss" in m for m in got) and "distill_tau" in got[-1]
    for g, w in zip(got, want):
        for k in w:
            assert g[k] == pytest.approx(w[k], abs=1e-5), (g, w)
    assert report["teacher"] == teacher and report["pairs"] == 16
    assert json.loads((d / "port" / "student_config.json").read_text()) == \
        json.loads((d / "jax" / "student_config.json").read_text()) == {"model": model,
                                                                         "overrides": {"num_hidden_layers": 2}}
    assert (d / "port" / "best.npz").exists() and (d / "port" / "student_final.npz").exists()
    # the student through cli/score.py and the sidecar at <ckpt>/.. scores as the run's final params
    score_cli.main(["--model", model, "--tsv", str(d / "pairs.tsv"), "--labels", str(d / "labels.txt"),
                    "--checkpoint", str(d / "port" / "best.npz"), "--out", str(d / "student.txt"), "--device", "cpu"])
    assert sum(map(len, load_tsv_scores(d / "student.txt").values())) == 24


@pytest.mark.parametrize("argv,match", [
    (["--student-layers", "2", "--student-overrides", "{}", "--teacher-checkpoint", "t"], "exactly one of"),
    (["--student-layers", "2"], "one of --teacher-scores"),
    (["--student-layers", "2", "--teacher-scores", "x", "--teacher-ensemble", "b", "c", "a", "l"], "exclusive"),
    (["--student-layers", "2", "--teacher-scores", "x", "--teacher-checkpoint", "t"], "only meaningful"),
    (["--student-layers", "2", "--teacher-scores", "x", "--init-from-teacher"], "requires --teacher-checkpoint"),
], ids=["both_shapes", "no_teacher", "two_offline", "two_signals", "init_without_checkpoint"])
def test_distill_cli_errors(argv, match, capsys):
    with pytest.raises(SystemExit) as e:
        distill_cli.main(["--model", "imagebert_a", "--tsv", "t", "--labels", "l", "--out", "o", *argv])
    assert e.value.code == 2 and match in capsys.readouterr().err


def test_distill_cli_lxmert_needs_the_stack_depths(capsys):
    with pytest.raises(SystemExit) as e:
        distill_cli.main(["--model", "lxmert", "--student-layers", "2", "--teacher-checkpoint", "t", "--tsv", "t",
                          "--labels", "l", "--out", "o"])
    assert e.value.code == 2 and "l_layers" in capsys.readouterr().err


def test_distill_cli_lxmert_student_on_the_cpu(files):
    d = files
    lx = numpy_like(jax.eval_shape(lambda: jax_get_model("lxmert", overrides={"l_layers": 3, "x_layers": 2,
                                                                              "r_layers": 2}).init_params(
        jax.random.key(0))), 15)
    save_npz(d / "lx.npz", lx)
    report = distill_cli.main(["--model", "lxmert", "--student-overrides", json.dumps({"l_layers": 2, "x_layers": 1,
                                                                                      "r_layers": 1}),
                               "--tsv", str(d / "pairs.tsv"), "--labels", str(d / "labels.txt"),
                               "--teacher-checkpoint", str(d / "lx.npz"), "--init-from-teacher", "--steps", "2",
                               "--batch-size", "8", "--out", str(d / "lx_run"), "--device", "cpu"])
    assert np.isfinite(report["distill_mae"]) and report["teacher"] == "live"
    tree = flatten_tree(load_npz(d / "lx_run" / "student_final.npz"))
    assert tree["bert/encoder/x_layers/visual_attention/query/kernel"].shape[0] == 1


def _train_argv(d: Path, model: str, *extra) -> list[str]:
    return ["--model", model, "--train-tsv", str(d / "pairs.tsv"), "--labels", str(d / "labels.txt"),
            "--query-labels", str(d / "query_labels.txt"), "--steps", "2", "--batch-size", "8", "--out",
            str(d / f"run_{model}"), "--device", "cpu", "--lr", "1e-3", "--warmup-steps", "1", *extra]


@pytest.mark.parametrize("model", ["imagebert_a", "imagebert_b"])
def test_train_cli_layers_init_from_and_distill_from(files, model, capsys):
    d = files
    teacher = str(d / ("a.npz" if model == "imagebert_a" else "b.npz"))
    trainer, state, report = train_cli.run(_train_argv(d, model, "--layers", "2", "--init-from", teacher,
                                                       "--distill-from", teacher, "--hard-loss-weight", "0.5"))
    assert report["steps"] == 2 and trainer.tc.distill_weight == 1.0 and trainer.tc.hard_loss_weight == 0.5
    assert trainer.tc.distill_temperature == 2.0
    first = _metrics(d / f"run_{model}" / "metrics.jsonl")[0]
    assert np.isfinite([first["loss"], first["distill_loss"]]).all()
    assert json.loads((d / f"run_{model}" / "student_config.json").read_text()) == {
        "model": model, "overrides": {"num_hidden_layers": 2}}
    # the init (a run of 0 steps): 2 of the teacher's 5 layers (indices 1 and 4), every other leaf the teacher's
    _, init_state, _ = train_cli.run(_train_argv(d, model, "--layers", "2", "--init-from", teacher, "--steps", "0",
                                                 "--out", str(d / "init_only")))
    got, want = flatten_tree(params_to_jax(init_state.params)), flatten_tree(load_npz(teacher))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k][[1, 4]] if k.startswith("bert/encoder/") else want[k],
                                      err_msg=k)
    out = d / "scores.txt"
    score_cli.main(["--model", model, "--tsv", str(d / "pairs.tsv"), "--labels", str(d / "labels.txt"),
                    "--checkpoint", str(d / f"run_{model}" / "step_2.npz"), "--out", str(out), "--device", "cpu"])
    assert "config overrides from" in capsys.readouterr().err
    assert sum(map(len, load_tsv_scores(out).values())) == 24


@pytest.mark.parametrize("model,extra,match", [
    ("imagebert_a", ["--resume", "s.npz", "--init-from", "x"], "mutually exclusive"),
    ("lxmert", ["--layers", "2"], "--student-overrides"),
    ("two_tower", ["--distill-from", "x"], "cross-encoder scorers"),
], ids=["resume_and_init_from", "layers_on_lxmert", "distill_two_tower"])
def test_train_cli_distillation_flag_errors(files, model, extra, match, capsys):
    with pytest.raises(SystemExit) as e:
        train_cli.run(_train_argv(files, model, *extra))
    assert e.value.code == 2 and match in capsys.readouterr().err


def test_score_fidelity_compare_matches_jax(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location("jax_script_score_fidelity", REPO / "scripts" / "score_fidelity.py")
    jax_fidelity = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_fidelity)
    rng = np.random.default_rng(16)
    ref = {str(q): {str(p): float(rng.random()) for p in range(12)} for q in range(6)}
    cand = {q: {p: s + 0.3 * float(rng.standard_normal()) for p, s in row.items()} for q, row in ref.items()}
    del cand["5"], cand["4"]["3"]  # a missing query and a missing pair
    cand["9"] = {"1": 0.5}
    cand["3"] = {"0": 0.1}  # one shared pid: no rank metric for the query
    for k in (1, 5, 20):
        assert score_fidelity.compare(ref, cand, k) == jax_fidelity.compare(ref, cand, k)
    assert score_fidelity.compare(ref, {}, 5) == jax_fidelity.compare(ref, {}, 5)
    _score_file(tmp_path / "ref.txt", [(q, p, s) for q, row in ref.items() for p, s in row.items()])
    _score_file(tmp_path / "cand.csv", [(q, p, s) for q, row in cand.items() for p, s in row.items()], "csv")
    answers = {q: list(row)[:3] for q, row in ref.items()}
    (tmp_path / "answers.json").write_text(json.dumps(answers))
    out = score_fidelity.main(["--reference", str(tmp_path / "ref.txt"), "--candidate", str(tmp_path / "cand.csv"),
                               "--answers", str(tmp_path / "answers.json")])
    assert json.loads(capsys.readouterr().out) == out
    assert out["missing_queries"] == 1 and out["missing_pairs"] == 1 + 11 and {"ndcg_ref", "ndcg_cand"} <= out.keys()
