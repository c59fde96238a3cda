"""CPU fixtures of the benchmark's tests: a cell resolved from ``BENCHMARK.json``
and cut to a tiny size (the port's plain f32 CPU path), run through the harness."""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY = {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 64}
TINY_TRAFFIC = {
    "imagebert_a.score_tsv": {"pairs": 700, "sample_pairs": 64, "batch_size": 64},
    "imagebert_b.train_packed": {"instances": 256, "batch_size": 32},
    "imagebert_a.score_staged": {"batches": 3, "batch_size": 32, "sample_pairs": 40},
}


def tiny_run(cell: str, tmp_path, seed: int = 2**31 + 12345, bert: dict | None = None, repo: Path = REPO, **traffic):
    import torch

    from portbench import harness

    run = harness.resolve(cell, repo=repo)
    run.config = {**run.config, "bert": {**run.config["bert"], **(TINY if bert is None else bert)}, "precision": "f32"}
    if "attention_backend" in run.config:
        run.config["attention_backend"] = "xla"
    run.traffic = {**run.traffic, **TINY_TRAFFIC.get(cell, {}), **traffic}
    run.seed, run.seconds, run.device, run.tmpdir = seed, 0.5, torch.device("cpu"), str(tmp_path)
    return run


def run_tiny(run) -> dict:
    from portbench import harness

    return harness.run_cell(run, time.perf_counter())


@pytest.fixture
def tiny(tmp_path):
    return lambda cell, **kw: tiny_run(cell, tmp_path, **kw)
