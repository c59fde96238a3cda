"""A later PR adds a cell by adding files and entries: a throwaway cell, its
configuration, traffic, limits and a per-layer reader of its own, in a copy of
the benchmark, found by name and run, with no file of the harness edited."""

from __future__ import annotations

import hashlib
import json
import shutil

from conftest import REPO, run_tiny, tiny_run

from portbench import harness


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_from_new_files_alone(tmp_path):
    repo = tmp_path / "checkout"
    shutil.copytree(REPO / "portbench", repo / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", repo / "BENCHMARK.json")
    before = _digests(repo / "portbench")
    pb = repo / "portbench"
    config = json.loads((pb / "configs" / "imagebert_a.json").read_text())
    (pb / "configs" / "imagebert_a_wide_batch.json").write_text(json.dumps(config))
    traffic = json.loads((pb / "traffic" / "score_tsv.json").read_text())
    (pb / "traffic" / "score_tsv_small.json").write_text(json.dumps({**traffic, "pairs": 600}))
    (pb / "limits" / "imagebert_a_wide_batch.score_tsv_small.json").write_text(json.dumps({"score_gap": 0.01}))
    (pb / "metrics" / "passes.count.py").write_text("def read(ctx):\n    return float(ctx['counts']['passes'])\n")
    bench = json.loads((repo / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "imagebert_a_wide_batch", "source": "https://example.org/a",
                             "file": "portbench/configs/imagebert_a_wide_batch.json", "reduced": [], "why": "a trial"})
    bench["workloads"].append({"name": "imagebert_a_wide_batch.score_tsv_small", "config": "imagebert_a_wide_batch",
                               "traffic": "score_tsv_small", "chips": 1, "why": "a trial"})
    for m in bench["end_to_end"]:
        if m["name"] == "score_pairs_per_s":
            m["workloads"].append("imagebert_a_wide_batch.score_tsv_small")
    bench["per_layer"].append({"name": "passes.count", "unit": "passes", "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "score_pairs_per_s",
                               "workloads": ["imagebert_a_wide_batch.score_tsv_small"]})
    (repo / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _digests(pb)
    assert all(after[p] == d for p, d in before.items())  # nothing the benchmark had was edited
    run = harness.resolve("imagebert_a_wide_batch.score_tsv_small", repo=repo)
    assert run.traffic["pairs"] == 600 and run.limits == {"score_gap": 0.01}
    assert [m["name"] for m in run.per_layer] == ["passes.count"]
    run = tiny_run("imagebert_a_wide_batch.score_tsv_small", tmp_path, repo=repo, pairs=600)
    out = run_tiny(run)
    assert out["correct"] and set(out["metrics"]) == {"score_pairs_per_s", "setup_s"}
    run.trace = True
    run.seed += 1
    out = run_tiny(run)
    assert out["correct"] and out["metrics"]["passes.count"]["value"] >= 1
