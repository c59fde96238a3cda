"""The yardstick's work counts, checked by hand at one shape."""

from __future__ import annotations

import json

import pytest
from conftest import REPO

from portbench.yardstick import peaks, work

A = json.loads((REPO / "portbench" / "configs" / "imagebert_a.json").read_text())
B = json.loads((REPO / "portbench" / "configs" / "imagebert_b.json").read_text())


def _cfg(c):
    return {**c["bert"], "seq_len": c["seq_len"], "feature_dim": c["feature_dim"]}


def test_gemm_and_attention_by_hand():
    assert work.gemm(2, 3, 4) == (48, 2 * (6 + 12 + 8))
    assert work.gemm(2, 3, 4, out_bytes=4) == (48, 12 + 24 + 32)
    assert work.attention_forward(1, 12, 40, 768, masked=False) == (4 * 40 * 40 * 768, 40 * 2304 * 2 + 40 * 768 * 2)
    assert work.attention_backward(2, 12, 30, 768, masked=True) == (
        8 * 2 * 30 * 30 * 768, 2 * (2 * 30 * 2304 * 2 + 30 * 768 * 2 + 30 * 4))
    f, b = work.label_conv(10, 768)
    assert f == 2 * 10 * 48 * 768 * 768  # 48 of the 64 (position, tap) blocks fall inside
    assert b == 10 * 8 * 768 * 2 + 8 * 768 * 768 * 2 + 10 * 8 * 768 * 4


def test_imagebert_a_pair_by_hand():
    w = work.imagebert_a_score([1], _cfg(A))
    layer = 2 * 40 * 768 * (3 * 768) + 2 * 40 * 768 * 768 + 2 * 2 * 40 * 768 * 3072 + 4 * 40 * 40 * 768
    assert w["model_flops"] == 12 * layer + 2 * 10 * 2048 * 768 + 2 * 768 * 768 + 2 * 768 * 2
    assert w["model_flops"] == pytest.approx(6.88e9, rel=0.01)
    assert len(w["gemm"]) == 12 * 4 + 3 and len(w["attention"]) == 12


def test_imagebert_b_step_by_hand():
    w = work.imagebert_b_train(1, 1, _cfg(B))
    layer = 2 * 30 * 768 * (3 * 768) + 2 * 30 * 768 * 768 + 2 * 2 * 30 * 768 * 3072 + 4 * 30 * 30 * 768
    forward = 12 * layer + 2 * 10 * 768 * 768 + 2 * 768 * 768 + 2 * 10 * 2048 * 768 + 2 * 10 * 48 * 768 * 768
    assert w["model_flops"] == 3 * forward
    assert len(w["attention"]) == 24 and len(w["gemm"]) == (12 * 4 + 2) * 3 + 2 + 3


def test_least_seconds_takes_the_larger_bound():
    assert peaks.least_seconds([(peaks.BF16_FLOPS, 0)]) == pytest.approx(1.0)
    assert peaks.least_seconds([(0, peaks.HBM_BYTES_PER_S), (peaks.BF16_FLOPS, 1)]) == pytest.approx(2.0)
