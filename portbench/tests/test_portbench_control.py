"""The control, the reference at fp8 put in the program's place, fails the
cells' limits at a size a test run holds on the CPU: ImageBERT-A at full width
and depth over a few sampled pairs; ImageBERT-B at full width and depth, one
step of a batch of 8 (the card reads the control at the cells' own sizes,
``control.py``). Once compared by hand, and once put in the program's place
underneath a whole run of the harness, whose check and judge then find the
run not correct."""

from __future__ import annotations

import numpy as np
import torch
from conftest import run_tiny, tiny_run

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.parallel import ScoringEngine
from portbench.entries import score_files, train_step


def test_the_fp8_control_fails_the_score_limit(tmp_path):
    torch.manual_seed(0)
    run = tiny_run("imagebert_a.score_tsv", tmp_path, bert={}, pairs=96, sample_pairs=48, batch_size=16)
    st = {"tsv": score_files.testb.write_testb_tsv(tmp_path / "t.tsv", run.traffic, run.seed),
          "sample": np.arange(48)}
    rows = score_files.sampled_rows(st)
    ref = score_files.reference_scores(run, rows)
    low = score_files.reference_scores(run, rows, lowp=True)
    assert np.max(np.abs(low - ref)) > run.limits["score_gap"]


def test_the_fp8_control_fails_a_training_limit(tmp_path):
    run = tiny_run("imagebert_b.train_packed", tmp_path, bert={}, instances=64, batch_size=8, checked_steps=1)
    ref = train_step.reference_numbers(run, [64])
    low = train_step.reference_numbers(run, [64], lowp=True)
    gaps = train_step.gaps(low, ref)
    assert any(gaps[name] > limit for name, limit in run.limits.items()), gaps


def test_the_fp8_control_in_the_programs_place_fails_a_scoring_run(tmp_path, monkeypatch):
    torch.manual_seed(0)
    run = tiny_run("imagebert_a.score_tsv", tmp_path, bert={}, pairs=96, sample_pairs=48, batch_size=16)
    tsv = score_files.testb.write_testb_tsv(tmp_path / "control.tsv", run.traffic, run.seed)
    rows = [r for r in map(score_files.ref_featurize.parse, score_files.testb.read_rows(tsv.path, tsv.offsets))
            if r is not None]
    low = score_files.reference_scores(run, rows, lowp=True)
    control = {(str(r["query_id"]), str(r["product_id"])): s for r, s in zip(rows, low)}
    finish = ScoringEngine._finish

    def fp8_scores(pending, stats):
        qid, pid, _ = finish(pending, stats)
        return qid, pid, np.array([control[(str(q), str(p))] for q, p in zip(qid, pid)], np.float32)

    monkeypatch.setattr(ScoringEngine, "_finish", staticmethod(fp8_scores))
    out = run_tiny(run)
    checks = {name: (value, limit) for name, value, limit in out["checks"]}
    assert not out["correct"] and checks["score_gap"][0] > checks["score_gap"][1], checks
    assert checks["missing_pairs"][0] == 0


def test_the_fp8_control_in_the_programs_place_fails_a_training_run(tmp_path, monkeypatch):
    run = tiny_run("imagebert_b.train_packed", tmp_path, bert={}, instances=64, batch_size=8, checked_steps=1)
    setup = train_step.setup

    def fp8_numbers(run):
        st = setup(run)
        st["program"] = train_step.reference_numbers(run, st["shard_sizes"], lowp=True)
        return st

    monkeypatch.setattr(train_step, "setup", fp8_numbers)
    out = run_tiny(run)
    assert not out["correct"], out["checks"]
