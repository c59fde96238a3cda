"""The port's spans and counters (``utils/observability.py``): with no
profiler running a span reads a flag and nothing else; under
``torch.profiler`` the record (names, threads, parents, times, counters), the
loader thread's spans, a fresh record a session; the spans and counters of
the scoring and training paths on a tiny TSV and a tiny packed shard;
``device_profile``'s trace with the spans on its clock; the benchmark's
five readers of them (``portbench/metrics/``), over the program's record and
over spans taken from outside a program that keeps none; and LXMERT's cross
blocks, their spans, the reader of their share and the bridge that spans
them from outside a program whose blocks open none."""

import json
import math
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch import VOCAB_PATH
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import (
    Featurizer,
    PackedDataset,
    PrefetchIterator,
    write_packed_shards,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.fast_pipeline import native_batches_from_files
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.synthetic import SYNTHETIC_LABELS, make_testb_tsv
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import get_model
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.parallel import ScoringEngine, ScoringStats
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.tokenization import FullTokenizer
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.train import Trainer
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.utils import observability as obs
from portbench import harness
from portbench.entries import score_stream_lxmert
from portbench.reference.tokenizer import Tokenizer
from portbench.yardstick import lxmert as bench_lxmert
from portbench.yardstick import packed as bench_packed
from portbench.yardstick import spans as bench_spans
from torch_parity import TINY, imagebert_b_batch

READERS = ["loader.wait_share.score", "h2d.gb_per_s.score", "packed.gather_ms.train",
           "host.enqueue_us_per_kernel.score", "host.enqueue_us_per_kernel.train"]
BATCH = 8


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _no_range(*args, **kwargs):
    raise AssertionError("a record_function range was opened with no profiler running")


class _Untouchable:
    """A module stand-in whose every attribute fails: what a span with no profiler running may not read."""

    def __init__(self, what: str):
        self.what = what

    def __getattr__(self, name):
        raise AssertionError(f"a span with no profiler running read {self.what}.{name}")


def test_with_no_profiler_a_span_reads_no_clock_opens_no_range_and_records_nothing(monkeypatch):
    assert not obs.tracing()  # finds torch's profiler and hooks the record's restart on (one clock pair)
    before = obs.recorded()
    monkeypatch.setattr(obs, "time", _Untouchable("time"))
    monkeypatch.setattr(obs, "threading", _Untouchable("threading"))
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _no_range)
    monkeypatch.setattr(torch.profiler, "record_function", _no_range)
    for _ in range(3):
        with obs.span("loader.wait"):
            with obs.span("engine.forward"):
                pass
        obs.count("h2d.bytes", 10)
    after = obs.recorded()
    assert after["spans"] == before["spans"] and after["counters"] == before["counters"]
    assert after["anchor"] == before["anchor"]


def test_meter_stage_opens_its_range_only_under_a_profiler(monkeypatch, tmp_path):
    m = obs.Meter()
    with monkeypatch.context() as patched:
        patched.setattr(torch.profiler, "record_function", _no_range)
        with m.stage("parse", items=2):
            pass
    assert m.counts["parse"] == 2 and m.seconds["parse"] > 0
    with obs.device_profile(str(tmp_path)):
        with m.stage("parse", items=1):
            pass
    events = json.loads(next(tmp_path.glob("*.pt.trace.json")).read_text())["traceEvents"]
    assert [e["cat"] for e in events if e.get("name") == "parse"] == ["user_annotation"]
    assert m.counts["parse"] == 3


def test_under_the_profiler_spans_record_name_thread_parent_times_and_counts():
    with _profiled():
        with obs.span("train.step"):
            with obs.span("train.forward_backward"):
                torch.ones(4).sum()
            with obs.span("train.optimizer"):
                with obs.span("optim.adam"):
                    pass
        obs.count("h2d.bytes", 3)
        obs.count("h2d.bytes", 7)
    rec = obs.recorded()
    assert [s.name for s in rec["spans"]] == ["train.step", "train.forward_backward", "train.optimizer", "optim.adam"]
    assert [s.parent for s in rec["spans"]] == [-1, 0, 0, 2]
    assert {s.thread for s in rec["spans"]} == {threading.get_native_id()}
    for s in rec["spans"]:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            up = rec["spans"][s.parent]
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns
    assert rec["counters"] == {"h2d.bytes": 10}


@pytest.mark.parametrize("session", ["torch.profiler", "torch.autograd.profiler"])
def test_each_profiler_session_starts_a_fresh_record(session):
    def start():
        return _profiled() if session == "torch.profiler" else torch.autograd.profiler.profile()

    with start():
        with obs.span("score.files"):
            pass
        obs.count("h2d.bytes", 5)
    anchor = obs.recorded()["anchor"]
    with obs.span("engine.forward"):  # between sessions: off
        pass
    with start():
        with obs.span("train.step"):
            pass
        obs.count("h2d.bytes")
    rec = obs.recorded()
    assert [s.name for s in rec["spans"]] == ["train.step"] and rec["counters"] == {"h2d.bytes": 1}
    assert rec["anchor"][0] > anchor[0]


def test_a_span_on_the_prefetch_thread_is_recorded():
    def produce():
        for i in range(3):
            with obs.span("loader.parse"):
                time.sleep(0.001)
            yield i

    with _profiled():
        assert list(PrefetchIterator(produce(), prefetch=1)) == [0, 1, 2]
    parsed = [s for s in obs.recorded()["spans"] if s.name == "loader.parse"]
    assert len(parsed) == 3 and all(s.end_ns - s.start_ns >= 1_000_000 for s in parsed)
    assert {s.thread for s in parsed} != {threading.get_native_id()} and len({s.thread for s in parsed}) == 1


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """A tiny ImageBERT-A scoring a 45-pair TSV (a malformed row among them) through ``score_files`` under the
    profiler: -> the record, the stats, the batches the loader yields, the spec, the window's seconds."""
    path = tmp_path_factory.mktemp("spans") / "pairs.tsv"
    path.write_text("\n".join(make_testb_tsv(45, seed=5, pairs_per_query=7)) + "\n")
    fz = Featurizer(FullTokenizer.google_style(VOCAB_PATH), SYNTHETIC_LABELS)
    spec = get_model("imagebert_a", overrides=TINY)
    engine = ScoringEngine(spec, spec.init_params(0), device="cpu")
    stats = ScoringStats()
    t0 = time.perf_counter()
    with _profiled():
        result = engine.score_files([path], fz, BATCH, stats=stats)
    seconds = time.perf_counter() - t0
    batches = list(native_batches_from_files([path], fz, spec.featurizer_layout, BATCH))
    assert sum(len(r) for r in result.values()) == stats.pairs == 45
    return {"record": obs.recorded(), "stats": stats, "batches": batches, "spec": spec, "seconds": seconds,
            "device": engine.device}


def test_scoring_a_tiny_tsv_fires_each_span_once_a_batch(scored):
    rec, stats = scored["record"], scored["stats"]
    names = Counter(s.name for s in rec["spans"])
    n = stats.batches
    assert n == len(scored["batches"]) == 6
    # loader.wait: once a batch, and once more for the end of the stream
    assert names["loader.wait"] == n + 1
    assert names["engine.h2d"] == names["engine.forward"] == names["engine.d2h"] == n
    assert names["score.files"] == names["loader.read"] == names["loader.parse"] == names["loader.featurize"] == 1
    assert names["loader.batch"] >= n
    main = threading.get_native_id()
    by_name = {}
    for s in rec["spans"]:
        by_name.setdefault(s.name, set()).add(s.thread)
    assert by_name["loader.wait"] == by_name["engine.forward"] == by_name["score.files"] == {main}
    # one byte span: one pool thread reads, parses and featurizes it; the prefetch thread batches it
    per_span = by_name["loader.read"] | by_name["loader.parse"] | by_name["loader.featurize"]
    assert len(per_span) == len(by_name["loader.batch"]) == 1 and per_span != by_name["loader.batch"]
    assert main not in per_span | by_name["loader.batch"]
    top = rec["spans"][[s.name for s in rec["spans"]].index("score.files")]
    assert all(rec["spans"][s.parent].name == "score.files" for s in rec["spans"] if s.name == "loader.wait")
    assert all(top.start_ns <= s.start_ns and s.end_ns <= top.end_ns for s in rec["spans"] if s.thread == main)
    # pairs, batches, rows and errors are ScoringStats' to count; the pinned ring's bytes are counted on CUDA only
    pinned = {"h2d.pinned_bytes"} if scored["device"].type == "cuda" else set()
    assert set(rec["counters"]) == {"h2d.bytes"} | pinned
    assert stats.pipeline.parsed == 45 and stats.pipeline.errors == 1


def test_h2d_bytes_are_the_bytes_of_the_batches_input_tensors(scored):
    keys = scored["spec"].input_keys
    want = sum(np.ascontiguousarray(b[k]).nbytes for b in scored["batches"] for k in keys)
    assert scored["record"]["counters"]["h2d.bytes"] == want


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Three steps of a tiny ImageBERT-B from a 12-instance packed shard (f16 features) under the profiler."""
    d = tmp_path_factory.mktemp("packed")
    spec = get_model("imagebert_b", overrides=TINY)
    full = imagebert_b_batch(12, spec.config.vocab_size, seed=3)
    write_packed_shards(({k: v[i] for k, v in full.items()} for i in range(12)), d, shard_size=12)
    batches = list(PackedDataset(d).batches(4, epochs=1, seed=0))
    trainer = Trainer(spec, device="cpu")
    state = trainer.init_state(seed=0)
    t0 = time.perf_counter()
    with _profiled():
        for batch in PackedDataset(d).batches(4, epochs=1, seed=0):
            trainer.train_step(state, batch, seed=7)
    return {"record": obs.recorded(), "batches": batches, "spec": spec, "trainer": trainer,
            "seconds": time.perf_counter() - t0}


def test_training_from_a_tiny_packed_shard_fires_each_span_once_a_step(trained):
    rec = trained["record"]
    names = Counter(s.name for s in rec["spans"])
    steps, layers = 3, trained["spec"].config.num_hidden_layers
    for name in ("packed.gather", "train.step", "train.h2d", "train.forward_backward", "train.optimizer",
                 "optim.clip", "optim.adam", "optim.ema"):
        assert names[name] == steps, name
    for name in ("block.attention_train", "block.ffn_train", "block.attention_train_bwd", "block.ffn_train_bwd"):
        assert names[name] == steps * layers, name
    parent = {s.name: rec["spans"][s.parent].name for s in rec["spans"] if s.parent >= 0}
    assert parent["train.forward_backward"] == parent["train.optimizer"] == parent["train.h2d"] == "train.step"
    assert parent["optim.adam"] == parent["optim.clip"] == parent["optim.ema"] == "train.optimizer"
    assert parent["block.attention_train_bwd"] == "train.forward_backward"  # the CPU runs backward in place
    assert rec["counters"] == {}  # training keeps no counter: no metric reads one there
    assert all(b["features"].dtype == np.float32 for b in trained["batches"])


def test_device_profile_puts_the_spans_on_the_traces_clock(tmp_path):
    def produce():
        with obs.span("loader.parse"):
            time.sleep(0.002)
        yield 1

    with obs.device_profile(str(tmp_path)):
        for _ in range(5):
            with obs.span("engine.forward"):
                torch.ones(8).sum()
            time.sleep(0.001)
        assert list(PrefetchIterator(produce(), prefetch=1)) == [1]
    trace = json.loads(next(tmp_path.glob("*.pt.trace.json")).read_text())
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    twin = [e for e in events if e["name"] == "engine.forward" and e["cat"] == "user_annotation"]
    ours = [e for e in events if e["name"] == "engine.forward" and e["cat"] == "program_span"]
    assert len(twin) == len(ours) == 5
    for a, b in zip(sorted(ours, key=lambda e: e["ts"]), sorted(twin, key=lambda e: e["ts"])):
        assert abs(a["ts"] - b["ts"]) < 100 and a["dur"] <= b["dur"] and a["tid"] == b["tid"]
    parse = [e for e in events if e["name"] == "loader.parse" and e["cat"] == "program_span"]
    assert len(parse) == 1 and parse[0]["tid"] != ours[0]["tid"] and parse[0]["dur"] >= 2000
    window = [e for e in events if e["cat"] == "cpu_op"]
    assert min(e["ts"] for e in window) - 1e6 < parse[0]["ts"] < max(e["ts"] for e in window) + 1e6


def _read(name: str, ctx: dict):
    return harness.load_reader(name)(ctx)


def _ctx(window_s: float, h2d_s: float = 0.0, kernels: int = 0) -> dict:
    return {"trace": {"window_s": window_s, "h2d_s": h2d_s, "kernels": kernels}, "counts": {}, "work": {},
            "extras": {}, "config": {}}


def test_the_five_readers_read_the_programs_record(scored, trained, monkeypatch):
    monkeypatch.setattr(obs, "recorded", lambda: scored["record"])
    rec = scored["record"]
    wait = sum(s.end_ns - s.start_ns for s in rec["spans"] if s.name == "loader.wait") * 1e-9
    forward = sum(s.end_ns - s.start_ns for s in rec["spans"] if s.name == "engine.forward") * 1e-9
    assert _read("loader.wait_share.score", _ctx(scored["seconds"])) == pytest.approx(100 * wait / scored["seconds"])
    assert 0 < _read("loader.wait_share.score", _ctx(scored["seconds"])) < 100
    ctx = _ctx(scored["seconds"], h2d_s=2e-3, kernels=500)
    assert _read("h2d.gb_per_s.score", ctx) == pytest.approx(rec["counters"]["h2d.bytes"] / 2e-3 / 1e9)
    assert _read("host.enqueue_us_per_kernel.score", ctx) == pytest.approx(1e6 * forward / 500)
    assert _read("h2d.gb_per_s.score", _ctx(1.0)) is None  # no device copy: nothing to read
    assert _read("host.enqueue_us_per_kernel.score", _ctx(1.0)) is None
    assert _read("packed.gather_ms.train", ctx) is None  # no packed.gather span in a scoring window

    monkeypatch.setattr(obs, "recorded", lambda: trained["record"])
    rec = trained["record"]
    gathers = [(s.end_ns - s.start_ns) * 1e-6 for s in rec["spans"] if s.name == "packed.gather"]
    step = sum(s.end_ns - s.start_ns for s in rec["spans"] if s.name in ("train.forward_backward",
                                                                           "train.optimizer")) * 1e-9
    ctx = _ctx(trained["seconds"], kernels=2000)
    assert _read("packed.gather_ms.train", ctx) == pytest.approx(sum(gathers) / 3)
    assert _read("host.enqueue_us_per_kernel.train", ctx) == pytest.approx(1e6 * step / 2000)
    assert _read("loader.wait_share.score", ctx) is None
    for name in READERS:
        value = _read(name, _ctx(1.0, h2d_s=1e-3, kernels=100) if "score" in name else ctx)
        assert value is None or math.isfinite(value)


def test_the_readers_are_entries_of_the_benchmark_with_their_cells():
    bench = {m["name"]: m for m in harness.load_benchmark()["per_layer"]}
    assert all(bench[n]["source"] in ("program_span", "program_counter") for n in READERS)
    assert bench["loader.wait_share.score"]["workloads"] == ["imagebert_a.score_tsv"]
    assert bench["packed.gather_ms.train"]["workloads"] == ["imagebert_b.train_packed"]


@pytest.fixture
def outside(monkeypatch):
    """A program without ``recorded()`` (a version before its recorder), the benchmark's outside spans put on
    for the test and taken off after it."""
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.train import Trainer as T

    for cls, name in [(ScoringEngine, "__init__"), (ScoringEngine, "to_device"), (PrefetchIterator, "__next__"),
                      (PackedDataset, "_assemble"), (T, "grads"), (T, "apply")]:
        monkeypatch.setattr(cls, name, cls.__dict__[name])
    monkeypatch.delattr(obs, "recorded")
    monkeypatch.setitem(bench_spans._OUTSIDE, "spans", [])
    monkeypatch.setitem(bench_spans._OUTSIDE, "counters", Counter())
    assert bench_spans.install_outside()
    return bench_spans._OUTSIDE


def test_a_program_without_its_record_gets_the_spans_from_outside(outside, tmp_path):
    path = tmp_path / "pairs.tsv"
    path.write_text("\n".join(make_testb_tsv(20, seed=6, pairs_per_query=5)) + "\n")
    fz = Featurizer(FullTokenizer.google_style(VOCAB_PATH), SYNTHETIC_LABELS)
    spec = get_model("imagebert_a", overrides=TINY)
    engine = ScoringEngine(spec, spec.init_params(0), device="cpu")
    engine.score_files([path], fz, BATCH)  # no profiler: nothing taken
    assert outside["spans"] == [] and not outside["counters"]
    stats = ScoringStats()
    with _profiled():
        engine.score_files([path], fz, BATCH, stats=stats)
    names = Counter(s[0] for s in outside["spans"])
    assert names["loader.wait"] == stats.batches + 1 and names["engine.forward"] == stats.batches
    batches = list(native_batches_from_files([path], fz, spec.featurizer_layout, BATCH))
    assert outside["counters"]["h2d.bytes"] == sum(b[k].nbytes for b in batches for k in spec.input_keys)
    assert bench_spans.record() is outside
    ctx = _ctx(1.0, h2d_s=1e-3, kernels=100)
    for name in ("loader.wait_share.score", "h2d.gb_per_s.score", "host.enqueue_us_per_kernel.score"):
        assert math.isfinite(_read(name, ctx)), name

    bspec = get_model("imagebert_b", overrides=TINY)
    full = imagebert_b_batch(8, bspec.config.vocab_size, seed=4)
    write_packed_shards(({k: v[i] for k, v in full.items()} for i in range(8)), tmp_path / "packed", shard_size=8)
    trainer = Trainer(bspec, device="cpu")
    state = trainer.init_state(seed=0)
    with _profiled():
        for batch in PackedDataset(tmp_path / "packed").batches(4, epochs=1, seed=0):
            trainer.train_step(state, batch, seed=1)
    names = Counter(s[0] for s in outside["spans"])
    assert names["packed.gather"] == names["train.forward_backward"] == names["train.optimizer"] == 2
    for name in ("packed.gather_ms.train", "host.enqueue_us_per_kernel.train"):
        assert math.isfinite(_read(name, ctx)), name


LXMERT_TINY = {**TINY, "l_layers": 1, "r_layers": 1, "x_layers": 2}


@pytest.fixture(scope="module")
def lxmert_scorer():
    """A tiny LXMERT on the blocks' route (each kernel's plain version on the CPU) and one batch of the
    benchmark's LXMERT cell."""
    spec = get_model("lxmert", overrides=LXMERT_TINY)
    engine = ScoringEngine(spec, spec.init_params(0), device="cpu", attention_backend="pallas_packed")
    tok = Tokenizer()
    lut, _ = bench_packed.label_lut(lambda text: list(tok.pieces(text)))
    traffic = {"batches": 1, "batch_size": 4, "pairs_per_query": 2, "min_boxes": 1, "max_boxes": 10}
    return engine, bench_lxmert.make_batches(traffic, 3, tok.query_ids, lut)[0]


def _profiled_forward(engine, batch) -> dict:
    before = obs.recorded()
    engine.score_batch(batch)  # no profiler: nothing recorded
    assert obs.recorded()["spans"] == before["spans"]
    with _profiled():
        engine.score_batch(batch)
    return obs.recorded()


@pytest.mark.parametrize("dual", [False, True])
def test_a_tiny_lxmert_forward_records_its_cross_blocks(lxmert_scorer, monkeypatch, dual):
    engine, batch = lxmert_scorer
    if dual:
        monkeypatch.setenv("KMR_DUAL_CROSS", "1")
    else:
        monkeypatch.delenv("KMR_DUAL_CROSS", raising=False)
    rec = _profiled_forward(engine, batch)
    names = Counter(s.name for s in rec["spans"])
    x = LXMERT_TINY["x_layers"]
    assert names["block.cross_attention"] == (0 if dual else 2 * x)
    assert names["block.dual_cross_attention"] == (x if dual else 0)
    assert names["engine.forward"] == 1 and names["block.attention"] == names["block.ffn"] == 1 + 1 + 2 * x
    forward = [s.name for s in rec["spans"]].index("engine.forward")
    assert all(s.parent == forward for s in rec["spans"] if s.name.startswith("block."))

    monkeypatch.setattr(obs, "recorded", lambda: rec)
    share = _read("cross.enqueue_share.score", _ctx(1.0))
    if dual:
        assert share is None  # no cross block ran: nothing to read
    else:
        cross = sum(s.end_ns - s.start_ns for s in rec["spans"] if s.name == "block.cross_attention")
        assert share == pytest.approx(100 * cross / (rec["spans"][forward].end_ns - rec["spans"][forward].start_ns))
        assert 0 < share < 100


def test_the_cross_share_is_an_entry_of_the_benchmark_for_the_lxmert_cell():
    m = {m["name"]: m for m in harness.load_benchmark()["per_layer"]}["cross.enqueue_share.score"]
    assert m["workloads"] == ["lxmert.score_staged"] and m["source"] == "program_span"
    assert m["layer"] == "blocks" and m["moves"] == "score_pairs_per_s" and m["better"] == "lower"


def test_a_program_whose_cross_block_opens_no_span_gets_it_from_outside(lxmert_scorer, monkeypatch):
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import lxmert as model
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.cross_attention_block import (
        cross_attention_block_plain,
    )

    engine, batch = lxmert_scorer
    monkeypatch.delenv("KMR_DUAL_CROSS", raising=False)
    assert not score_stream_lxmert.span_cross_blocks_from_outside()  # this program's block opens its span
    monkeypatch.setattr(model, "KERNEL_BLOCKS", model.KERNEL_BLOCKS._replace(cross=cross_attention_block_plain))
    assert Counter(s.name for s in _profiled_forward(engine, batch)["spans"])["block.cross_attention"] == 0
    assert score_stream_lxmert.span_cross_blocks_from_outside()
    assert not score_stream_lxmert.span_cross_blocks_from_outside()  # wrapped once
    rec = _profiled_forward(engine, batch)
    assert Counter(s.name for s in rec["spans"])["block.cross_attention"] == 2 * LXMERT_TINY["x_layers"]
    monkeypatch.setattr(obs, "recorded", lambda: rec)
    assert 0 < _read("cross.enqueue_share.score", _ctx(1.0)) < 100
