"""The port's ``utils/`` (``Meter``, ``log_metrics``, ``device_profile``, ``enable_persistent_compile_cache``)
against the JAX package's, ``ops/attention.py:best_mha`` on CPU tensors, and the perf CLIs (``cli/bench_all.py``,
``cli/perf_lab.py``): their arguments, one tiny subcommand each with ``--device cpu``, and the refused Pallas
variants exiting 2."""

import io
import json
import os

import numpy as np
import pytest
import torch

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.utils import observability as jax_obs
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import bench_all, perf_lab
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops import attention
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.utils import (
    Meter,
    device_profile,
    enable_persistent_compile_cache,
    log_metrics,
)
from torch_parity import TINY

METRICS = [
    {"loss": 0.6931471824645996, "accuracy": 0.5},
    {"grad_norm": np.float32(1.25), "lr": 2e-05, "note": "warmup"},
    {"valid_ndcg5": 0.123456789012345, "best": None},
    {},
]


@pytest.mark.parametrize("metrics", METRICS)
def test_log_metrics_bytes_equal_jax(metrics):
    got, want = io.StringIO(), io.StringIO()
    log_metrics(7, metrics, got)
    jax_obs.log_metrics(7, metrics, want)
    assert got.getvalue() == want.getvalue()


def test_log_metrics_takes_0d_tensors():
    got, want = io.StringIO(), io.StringIO()
    log_metrics(3, {"loss": torch.tensor(0.25)}, got)
    jax_obs.log_metrics(3, {"loss": 0.25}, want)
    assert got.getvalue() == want.getvalue()


def test_meter_summary_matches_jax_shape():
    m, jm = Meter(), jax_obs.Meter()
    for meter in (m, jm):
        with meter.stage("parse", items=100):
            pass
        with meter.stage("parse", items=50):
            pass
        with meter.stage("score"):
            pass
    s, js = m.summary(), jm.summary()
    assert s.keys() == js.keys() == {"parse", "score"}
    assert s["parse"]["count"] == 150 and s["score"]["count"] == 0 and s["score"]["per_second"] == 0.0
    assert all(v.keys() == js["parse"].keys() for v in s.values())
    assert m.rate("parse") == pytest.approx(150 / m.seconds["parse"]) and m.rate("absent") == 0.0


def test_device_profile_writes_a_trace(tmp_path):
    with device_profile(str(tmp_path)):
        torch.matmul(torch.ones(8, 8), torch.ones(8, 8))
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::matmul" in e.get("name", "") for e in events)
    with device_profile(None):  # a no-op
        pass


def test_stage_is_a_profiler_range(tmp_path):
    m = Meter()
    with device_profile(str(tmp_path)):
        with m.stage("featurize", items=3):
            torch.ones(4).sum()
    events = json.loads(next(tmp_path.glob("*.pt.trace.json")).read_text())["traceEvents"]
    assert any(e.get("name") == "featurize" for e in events)


def test_persistent_compile_cache_on_the_cpu_builds_nothing(monkeypatch):
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "build_all", lambda: pytest.fail("no build on the CPU"))
    enable_persistent_compile_cache()


@pytest.mark.parametrize("has_bias", [False, True])
def test_best_mha_on_cpu_is_xla(has_bias):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 4, 10, 8, generator=g) for _ in range(3))
    bias = torch.randn(2, 1, 1, 10, generator=g) if has_bias else None
    assert attention.backend_choice(q, bias) == "xla"
    assert torch.equal(attention.best_mha(q, k, v, bias), attention.mha_xla(q, k, v, bias))
    assert attention._backend_choice.cache_info().currsize == 0  # nothing timed


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setenv("KMR_CONFIG_OVERRIDES", json.dumps(TINY))
    monkeypatch.delenv("KMR_BLOCKS", raising=False)


def test_bench_all_one_line_a_scorer(tiny, capsys):
    lines = bench_all.main(["--device", "cpu", "--batch-size", "4", "--iters", "1", "--ensemble"])
    printed = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert printed == lines
    assert [x["model"] for x in lines] == [*bench_all.MODELS, "ensemble_4x", "ensemble_delta_c"]
    assert all(x["pairs_per_sec_per_chip"] > 0 and x["backend"] == "xla" for x in lines[:4])
    assert all(x["card"] == "cpu" for x in lines)


@pytest.mark.parametrize("argv", [
    ["model", "imagebert_a", "4"],
    ["model_q8", "imagebert_b", "4", "full"],
    ["stages", "imagebert_a", "4"],
    ["attn", "10", "2"],
    ["ffn", "10", "2"],
    ["cross", "5", "3", "2"],
    ["int8", "32", "64", "16"],
])
def test_perf_lab_subcommand_on_cpu(tiny, capsys, argv):
    perf_lab.main([*argv, "--device", "cpu", "--iters", "1"])
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert lines and all(x["cmd"] == argv[0] and x["card"] == "cpu" for x in lines)
    assert all(x.get("ms", 1.0) > 0 for x in lines)


@pytest.mark.parametrize("cmd", ["attn_hm", "attn_hp", "cross_hp"])
def test_perf_lab_refuses_pallas_variants(cmd, capsys):
    with pytest.raises(SystemExit) as e:
        perf_lab.main([cmd, "40", "--device", "cpu"])
    assert e.value.code == 2 and "ROADMAP" in capsys.readouterr().err


def test_perf_lab_refuses_kmr_blocks(monkeypatch, capsys):
    monkeypatch.setenv("KMR_BLOCKS", "8,16")
    with pytest.raises(SystemExit) as e:
        perf_lab.main(["attn", "40", "--device", "cpu"])
    assert e.value.code == 2 and "KMR_BLOCKS" in capsys.readouterr().err


def test_perf_lab_unknown_subcommand_exits_2():
    with pytest.raises(SystemExit) as e:
        perf_lab.main(["no_such", "--device", "cpu"])
    assert e.value.code == 2
    assert os.environ.get("KMR_BLOCKS") is None


def test_perf_lab_artifact_and_trace_on_cpu(tiny, tmp_path, capsys):
    """``artifact`` times a reloaded ``cli/export.py`` artifact; ``trace`` writes a trace into its directory."""
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.cli import export as export_cli

    out = tmp_path / "art"
    export_cli.main(["--model", "imagebert_a", "--batch-size", "4", "--quantize", "int8-ffn", "--device", "cpu",
                     "--out", str(out)])
    capsys.readouterr()
    perf_lab.main(["artifact", str(out), "--device", "cpu", "--iters", "1"])
    perf_lab.main(["trace", "imagebert_a", "4", str(tmp_path / "trace"), "--device", "cpu"])
    art, trace = (json.loads(x) for x in capsys.readouterr().out.strip().splitlines()[-2:])
    assert art["cmd"] == "artifact" and art["B"] == 4 and art["quantize"] == "int8-ffn" and art["ms"] > 0
    assert trace["cmd"] == "trace" and any(f.endswith(".pt.trace.json") for f in trace["files"])
