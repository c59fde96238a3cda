"""The plain reference and the port's plain f32 CPU path agree at a tiny size,
through the harness's own check: same weights, inputs, batches and dropout
masks, each worked out by the reference on its own."""

from __future__ import annotations

import pytest
from conftest import run_tiny


@pytest.mark.parametrize("cell", ["imagebert_a.score_tsv", "imagebert_b.train_packed", "imagebert_a.score_staged"])
def test_reference_agrees_with_the_ports_cpu_path(tiny, cell):
    out = run_tiny(tiny(cell))
    assert out["correct"], out["checks"]
    for name, value, _ in out["checks"]:
        assert value <= 1e-5, (name, value)  # f32 on both sides: summation order only
    assert out["failed"] == 0 and out["attempted"] > 0


def test_the_reference_counts_the_malformed_row_and_every_pair(tiny):
    run = tiny("imagebert_a.score_tsv", malformed=3)
    out = run_tiny(run)
    checks = {n: v for n, v, _ in out["checks"]}
    assert checks["parse_errors_gap"] == 0 and checks["pairs_per_pass_gap"] == 0 and checks["missing_pairs"] == 0
