"""A run with the timed path broken underneath comes out not correct, once for
each fault the cells can have (one chip: no exchange between chips):
an answer altered where it is produced; a step that returns its state
unchanged; half of the batch left out, the mean taken over the rest; and the
training step's value clip left out."""

from __future__ import annotations

import pytest
from conftest import run_tiny

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.parallel import ScoringEngine
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.train import Trainer, trainer


@pytest.mark.parametrize("cell", ["imagebert_a.score_tsv", "imagebert_a.score_staged"])
def test_an_answer_altered_where_it_is_produced(tiny, monkeypatch, cell):
    finish = ScoringEngine._finish

    def altered(pending, stats):
        qid, pid, scores = finish(pending, stats)
        scores = scores.copy()
        scores[::8] += 0.05  # one answer in eight, so the seed's sample holds some
        return qid, pid, scores

    monkeypatch.setattr(ScoringEngine, "_finish", staticmethod(altered))
    out = run_tiny(tiny(cell, sample_pairs=96))
    assert not out["correct"], out["checks"]


def test_a_step_that_returns_its_state_unchanged(tiny, monkeypatch):
    monkeypatch.setattr(Trainer, "apply", lambda self, state, grads: {})
    out = run_tiny(tiny("imagebert_b.train_packed"))
    checks = {n: v for n, v, _ in out["checks"]}
    assert not out["correct"] and checks["change_gap"] > 0.99


def test_half_of_the_batch_left_out(tiny, monkeypatch):
    to_device = Trainer.to_device

    def half(self, batch):
        return {k: v[: len(v) // 2] for k, v in to_device(self, batch).items()}

    monkeypatch.setattr(Trainer, "to_device", half)
    out = run_tiny(tiny("imagebert_b.train_packed"))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("clip", [True, False])
def test_the_value_clip_left_out(tiny, monkeypatch, clip):
    run = tiny("imagebert_b.train_packed")
    run.config = {**run.config, "recipe": {**run.config["recipe"], "clip_value": 1e-3}}  # bites at this size
    if not clip:
        monkeypatch.setattr(trainer, "clip_by_value", lambda grads, clip_value: None)
    out = run_tiny(run)
    checks = {n: (v, limit) for n, v, limit in out["checks"]}
    assert out["correct"] == clip, checks
    assert (checks["clip_excess"][0] > 10) != clip
