"""``ScoringEngine.score_stream`` against ``score_batch`` on each batch alone, for ImageBERT-A and LXMERT.

On the CPU the stream scores each batch through ``score_batch`` and keeps no ring. On the card it stages each
batch through its two-slot pinned ring, copies it in on a side stream and reads its scores back through pinned
memory; the scores are bit-equal to ``score_batch``'s on the same batch: over batches of different contents
with a padded tail, with a caller that overwrites its arrays in place once asked for the next batch, and with
shapes that change between batches (the slots' buffers made again); traced, ``h2d.pinned_bytes`` equals
``h2d.bytes``. Each slot replays the forward as a CUDA graph from the second batch of a layout on: the replayed
scores are bit-equal to ``score_batch``'s, traced the counters show two captures and a replay for every other
batch and the device runs every batch's kernels while the host launches those of four batches, new weights or
a new batch size capture again, and the graphs are dropped when the stream ends. The capture rule itself
(``graph_phase``, ``layout_key``) and the route switches it keys on (``models/core.py:route_key``) are held on
the CPU. The card's tests take the ``cuda`` fixture and skip without a GPU. The file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_score_stream.py
"""

import ast
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import Precision, get_model
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models.core import ROUTE_SWITCHES, route_key, route_switch
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops import kernels
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.parallel import ScoringEngine, ScoringStats
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.parallel.engine import graph_phase, layout_key
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.utils import observability as obs
from torch_parity import TINY, cuda, imagebert_a_batch  # noqa: F401  (cuda: fixture)

MODELS = ["imagebert_a", "lxmert"]
# the card's models: the published widths, few layers
CARD_DEPTHS = {"imagebert_a": {"num_hidden_layers": 2}, "lxmert": {"l_layers": 1, "x_layers": 1, "r_layers": 1}}
CPU_DEPTHS = {"imagebert_a": TINY, "lxmert": {**TINY, "l_layers": 1, "x_layers": 1, "r_layers": 1}}


def _batch(model: str, spec, b: int, seed: int, n_valid: int | None = None) -> dict[str, np.ndarray]:
    """A seeded batch of ``model``'s serving layout with ids and a ``valid`` mask; the rows past ``n_valid``
    padded with zeros, as a loader pads its tail batch."""
    r = np.random.default_rng(seed)
    if model == "lxmert":
        vocab = spec.config.bert.vocab_size
        n_query, n_boxes = r.integers(3, 24, b), r.integers(1, 11, b)
        batch = {"input_ids": r.integers(0, vocab, (b, 23)).astype(np.int32),
                 "input_mask": (np.arange(23)[None] < n_query[:, None]).astype(np.int32),
                 "label_ids": r.integers(0, vocab, (b, 10, 8)).astype(np.int32),
                 "boxes": r.random((b, 10, 4)).astype(np.float32),
                 "features": r.standard_normal((b, 10, 2048)).astype(np.float32),
                 "feats_mask": (np.arange(10)[None] < n_boxes[:, None]).astype(np.float32)}
    else:
        batch = imagebert_a_batch(b, spec.config.vocab_size, seed + 1)
    n_valid = b if n_valid is None else n_valid
    for v in batch.values():
        v[n_valid:] = 0
    batch["labels"] = np.ones(b, np.int32)
    batch["query_id"] = 1000 * seed + np.arange(b, dtype=np.int64) // 7
    batch["product_id"] = 1000 * seed + np.arange(b, dtype=np.int64)
    batch["valid"] = np.arange(b) < n_valid
    return batch


def _batches(model: str, spec, sizes, tail: int) -> list[dict[str, np.ndarray]]:
    """One batch a size, each of other contents, the last padded past its first ``tail`` rows."""
    return [_batch(model, spec, b, 10 + i, tail if i == len(sizes) - 1 else None) for i, b in enumerate(sizes)]


def _alone(engine: ScoringEngine, batch: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """What the stream should yield for ``batch``: ``score_batch`` on it alone, valid rows only."""
    valid = batch["valid"]
    return batch["query_id"][valid], batch["product_id"][valid], engine.score_batch(batch).float().cpu().numpy()[valid]


def _assert_bit_equal(got, want):
    assert len(got) == len(want)
    for (gq, gp, gs), (wq, wp, ws) in zip(got, want):
        np.testing.assert_array_equal(gq, wq)
        np.testing.assert_array_equal(gp, wp)
        assert gs.dtype == ws.dtype == np.float32 and gs.tobytes() == ws.tobytes()


def _engine(model: str, device, depths) -> tuple[ScoringEngine, object]:
    spec = get_model(model, overrides=depths[model])
    return ScoringEngine(spec, spec.init_params(3), device=device), spec


@pytest.mark.parametrize("model", MODELS)
def test_cpu_stream_yields_score_batch_of_each_batch_and_keeps_no_ring(model):
    """Traced: ``engine.h2d``, ``engine.forward`` and ``engine.d2h`` once a batch, and ``h2d.bytes`` alone."""
    engine, spec = _engine(model, "cpu", CPU_DEPTHS)
    batches = _batches(model, spec, [8] * 7, tail=3)
    want = [_alone(engine, b) for b in batches]
    stats = ScoringStats()
    with profile(activities=[ProfilerActivity.CPU]):
        got = list(engine.score_stream(iter(batches), stats))
    _assert_bit_equal(got, want)
    assert (stats.batches, stats.pairs) == (7, 6 * 8 + 3)
    assert engine._slots is None and engine._copy_stream is None
    assert engine._capture_stream is None and engine._graph_pool is None
    rec = obs.recorded()
    names = Counter(s.name for s in rec["spans"])
    assert names["engine.h2d"] == names["engine.forward"] == names["engine.d2h"] == 7
    assert rec["counters"] == {"h2d.bytes": sum(b[k].nbytes for b in batches for k in spec.input_keys)}


@pytest.mark.parametrize("model", MODELS)
def test_cuda_ring_scores_bit_equal_to_score_batch(cuda, model):
    """Seven batches of 64 (the last padded past 37 rows), each of other contents, through the ring."""
    engine, spec = _engine(model, cuda, CARD_DEPTHS)
    batches = _batches(model, spec, [64] * 7, tail=37)
    want = [_alone(engine, b) for b in batches]
    stats = ScoringStats()
    _assert_bit_equal(list(engine.score_stream(iter(batches), stats)), want)
    assert (stats.batches, stats.pairs) == (7, 6 * 64 + 37)
    _assert_bit_equal(list(engine.score_stream(iter(batches))), want)  # a second stream reuses the slots


@pytest.mark.parametrize("model", MODELS)
def test_cuda_ring_takes_a_loader_that_reuses_its_arrays(cuda, model):
    """The caller refills one set of arrays in place for every batch, as soon as it is asked for the next."""
    engine, spec = _engine(model, cuda, CARD_DEPTHS)
    batches = _batches(model, spec, [64] * 6, tail=20)
    want = [_alone(engine, b) for b in batches]
    reused = {k: v.copy() for k, v in batches[0].items()}

    def refilled():
        for b in batches:
            for k, v in b.items():
                np.copyto(reused[k], v)
            yield reused

    _assert_bit_equal(list(engine.score_stream(refilled())), want)


@pytest.mark.parametrize("model", MODELS)
def test_cuda_ring_makes_its_buffers_again_when_the_shapes_change(cuda, model):
    engine, spec = _engine(model, cuda, CARD_DEPTHS)
    batches = _batches(model, spec, [64, 64, 32, 48, 64, 16, 64], tail=50)
    want = [_alone(engine, b) for b in batches]
    _assert_bit_equal(list(engine.score_stream(iter(batches))), want)
    assert [s.layout[0][1][0] for s in engine._slots] == [64, 16]  # the last batch went through slot 0


def test_cuda_ring_counts_pinned_bytes_equal_to_h2d_bytes(cuda):
    engine, spec = _engine("imagebert_a", cuda, CARD_DEPTHS)
    batches = _batches("imagebert_a", spec, [64] * 4, tail=9)
    engine.score_batch(batches[0])
    with profile(activities=[ProfilerActivity.CPU]):
        list(engine.score_stream(iter(batches)))
    rec = obs.recorded()
    names = Counter(s.name for s in rec["spans"])
    assert names["engine.h2d"] == names["engine.forward"] == names["engine.d2h"] == 4
    want = sum(b[k].nbytes for b in batches for k in spec.input_keys)
    assert rec["counters"] == {"h2d.bytes": want, "h2d.pinned_bytes": want, "engine.graph_captures": 2,
                               "engine.graph_replays": 2}


# ---- the slots' CUDA graphs ----------------------------------------------------------------------------------

A_LAYOUT = {"input_ids": torch.zeros(8, 20, dtype=torch.int32), "features": torch.zeros(8, 10, 16)}


@pytest.mark.parametrize("runs, want", [(0, ("eager", 1)), (1, ("capture", 2)), (2, ("replay", 3)),
                                        (40, ("replay", 41))])
def test_graph_phase_is_eager_then_capture_then_replay(runs, want):
    """A slot's batches of the layout it holds: the first eager, the second captured, every later one replayed."""
    layout = layout_key(A_LAYOUT, "pallas_packed")
    assert graph_phase(layout, layout, runs) == want


def test_graph_phase_over_a_stream_of_layouts():
    """One slot's sequence: a new layout starts over, a layout that comes back starts over too."""
    big, small = layout_key(A_LAYOUT, "pallas_packed"), layout_key({k: v[:4] for k, v in A_LAYOUT.items()},
                                                                     "pallas_packed")
    held, runs, phases = None, 0, []
    for layout in (big, big, big, big, small, small, small, big, big):
        phase, runs = graph_phase(held, layout, runs)
        held = layout
        phases.append(phase)
    assert phases == ["eager", "capture", "replay", "replay", "eager", "capture", "replay", "eager", "capture"]


@pytest.mark.parametrize("change", ["shape", "dtype", "key", "backend", *ROUTE_SWITCHES])
def test_a_changed_layout_or_route_resets_the_capture_rule(change, monkeypatch):
    """Each of what the forward's route depends on is part of the slot's layout: changing it runs the next batch
    eagerly; the same one keeps replaying."""
    for name in ROUTE_SWITCHES:
        monkeypatch.delenv(name, raising=False)
    held = layout_key(A_LAYOUT, "pallas_packed")
    assert layout_key(dict(A_LAYOUT), "pallas_packed") == held
    inputs, backend = dict(A_LAYOUT), "pallas_packed"
    if change == "shape":
        inputs["features"] = torch.zeros(8, 10, 32)
    elif change == "dtype":
        inputs["features"] = torch.zeros(8, 10, 16, dtype=torch.bfloat16)
    elif change == "key":
        inputs["label_ids"] = inputs.pop("features")
    elif change == "backend":
        backend = "xla"
    else:
        monkeypatch.setenv(change, "1")
    layout = layout_key(inputs, backend)
    assert layout != held
    assert graph_phase(held, layout, 5) == ("eager", 1)
    assert graph_phase(held, held, 5) == ("replay", 6)


def test_route_key_reports_each_route_switch(monkeypatch):
    """``route_key`` is every switch of ROUTE_SWITCHES and whether it is "1"; ``route_switch`` reads no other."""
    for name in ROUTE_SWITCHES:
        monkeypatch.delenv(name, raising=False)
    assert route_key() == tuple((name, False) for name in ROUTE_SWITCHES)
    monkeypatch.setenv(ROUTE_SWITCHES[-1], "1")
    monkeypatch.setenv(ROUTE_SWITCHES[0], "0")
    assert route_key() == (*((name, False) for name in ROUTE_SWITCHES[:-1]), (ROUTE_SWITCHES[-1], True))
    with pytest.raises(KeyError):
        route_switch("KMR_CONFIG_OVERRIDES")


def _environment_reads(path: Path) -> set[str]:
    """The functions of a module that read the environment (``os.environ``, ``os.getenv``)."""
    found = set()

    def visit(node, where):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            where = node.name
        if isinstance(node, ast.Attribute) and node.attr in ("environ", "getenv"):
            found.add(where)
        for child in ast.iter_child_nodes(node):
            visit(child, where)

    visit(ast.parse(path.read_text()), "<module>")
    return found


def test_the_forward_reads_its_route_from_the_environment_through_route_switch_alone():
    """Of the modules a forward runs (``models/``, ``ops/``), ``core.route_switch`` alone reads the environment
    while a forward runs; the other reads come before one (a spec's config overrides, the CUDA toolkit's place)
    or in training (the train blocks' batch blocks). So a switch a forward's route reads is in ``route_key``,
    and a slot's graph is keyed by it."""
    pkg = Path(ScoringEngine.__module__.replace(".", "/")).parts[0]
    root = Path(__file__).resolve().parents[1] / pkg
    reads = {f"{path.parent.name}/{path.name}:{fn}" for sub in ("models", "ops") for path in (root / sub).glob("*.py")
             for fn in _environment_reads(path)}
    assert reads == {"models/core.py:route_switch", "models/registry.py:_bert_config",
                     "models/two_tower.py:two_tower_config", "ops/_build.py:nvcc", "ops/dropout.py:train_block"}


@pytest.mark.parametrize("model", MODELS)
def test_cpu_stream_makes_no_graph_across_new_weights(model):
    """A CPU engine's stream, before and after ``update_params``, yields ``score_batch`` of each batch under the
    weights of the moment and counts no capture or replay."""
    engine, spec = _engine(model, "cpu", CPU_DEPTHS)
    batches = _batches(model, spec, [8] * 4, tail=5)
    _assert_bit_equal(list(engine.score_stream(iter(batches))), [_alone(engine, b) for b in batches])
    engine.update_params(spec.init_params(4))
    want = [_alone(engine, b) for b in batches]
    with profile(activities=[ProfilerActivity.CPU]):
        got = list(engine.score_stream(iter(batches)))
    _assert_bit_equal(got, want)
    assert engine._slots is None and engine._graph_pool is None
    assert not {"engine.graph_captures", "engine.graph_replays"} & set(obs.recorded()["counters"])


def _graph_counters() -> dict:
    counters = obs.recorded()["counters"]
    return {k: counters.get(k, 0) for k in ("engine.graph_captures", "engine.graph_replays")}


def _graph_pool_bytes() -> int:
    """The bytes the caching allocator keeps in private pools, those of CUDA graphs."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot() if tuple(seg["segment_pool_id"]) != (0, 0))


def _gemm_launches_a_batch(engine: ScoringEngine, batch: dict) -> int:
    """``gemm``'s host launches in one eager forward of ``batch``."""
    before = kernels.gemm.launches
    engine.score_batch(batch)
    return kernels.gemm.launches - before


@pytest.mark.parametrize("model", MODELS)
def test_cuda_graph_replays_bit_equal_to_score_batch(cuda, model):
    """Eight batches of 64, the last padded past 29 rows, through both slots: the first of each slot eager, the
    second captured and replayed, the rest replayed; every batch's scores bit-equal to ``score_batch``'s. The
    host launches the kernels of four batches (each slot's eager batch and its capture) and no replay's; the
    graphs and their pool go when the stream ends, and a second stream captures again."""
    engine, spec = _engine(model, cuda, CARD_DEPTHS)
    batches = _batches(model, spec, [64] * 8, tail=29)
    want = [_alone(engine, b) for b in batches]
    per_batch = _gemm_launches_a_batch(engine, batches[0])
    before = kernels.gemm.launches
    stats = ScoringStats()
    _assert_bit_equal(list(engine.score_stream(iter(batches), stats)), want)
    assert (stats.batches, stats.pairs) == (8, 7 * 64 + 29)
    assert per_batch > 0 and kernels.gemm.launches - before == 4 * per_batch
    assert all(s.graph is None and s.out is None and s.runs == 0 for s in engine._slots)
    kept = _graph_pool_bytes()
    _assert_bit_equal(list(engine.score_stream(iter(batches))), want)
    assert kernels.gemm.launches - before == 8 * per_batch and _graph_pool_bytes() == kept


@pytest.mark.parametrize("model", MODELS)
def test_cuda_graph_counters_under_a_profiler(cuda, model):
    """Captured under a running profiler session: two captures, one a slot, and a replay for every batch but
    each slot's first; ``engine.forward`` once a batch; in the trace the device runs every batch's
    ``gemm_bf16_kernel`` launches, while the host launched four batches' worth."""
    engine, spec = _engine(model, cuda, CARD_DEPTHS)
    batches = _batches(model, spec, [64] * 7, tail=11)
    want = [_alone(engine, b) for b in batches]
    per_batch = _gemm_launches_a_batch(engine, batches[0])
    before = kernels.gemm.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = list(engine.score_stream(iter(batches)))
        torch.cuda.synchronize()
    _assert_bit_equal(got, want)
    assert _graph_counters() == {"engine.graph_captures": 2, "engine.graph_replays": 7 - 2}
    assert Counter(s.name for s in obs.recorded()["spans"])["engine.forward"] == 7
    on_device = sum(e.count for e in prof.key_averages()
                    if str(e.device_type).endswith("CUDA") and "gemm_bf16_kernel" in e.key)
    assert per_batch > 0 and kernels.gemm.launches - before == 4 * per_batch and on_device == 7 * per_batch


@pytest.mark.parametrize("model", MODELS)
def test_cuda_stream_left_early_drops_its_graphs(cuda, model):
    """A caller that stops reading after five of eight batches: closing the stream drops both graphs and gives
    their pool back to the device (what stays in private pools is what stayed after a whole stream: the
    capture stream's library workspaces, made in its first capture), and the next stream is bit-equal from
    its first batch."""
    engine, spec = _engine(model, cuda, CARD_DEPTHS)
    batches = _batches(model, spec, [64] * 8, tail=50)
    want = [_alone(engine, b) for b in batches]
    _assert_bit_equal(list(engine.score_stream(iter(batches))), want)
    kept = _graph_pool_bytes()
    stream = engine.score_stream(iter(batches))
    _assert_bit_equal([next(stream) for _ in range(5)], want[:5])
    assert all(s.graph is not None for s in engine._slots) and _graph_pool_bytes() > kept
    stream.close()
    assert all(s.graph is None for s in engine._slots) and _graph_pool_bytes() == kept
    _assert_bit_equal(list(engine.score_stream(iter(batches))), want)


def _imagebert_b_batches(tmp_path, spec) -> list[dict[str, np.ndarray]]:
    """ImageBERT-B's featurized batches of 16 from a 90-row synthetic TSV: five full, the sixth padded."""
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch import VOCAB_PATH
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import Featurizer, batches_from_files
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.synthetic import SYNTHETIC_LABELS, make_tsv
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.tokenization import FullTokenizer

    path = tmp_path / "pairs.tsv"
    path.write_text("\n".join(make_tsv(90, seed=4)) + "\n")
    fz = Featurizer(FullTokenizer.google_style(VOCAB_PATH), SYNTHETIC_LABELS)
    batches = list(batches_from_files([path], fz.for_model(spec.featurizer_layout), 16))
    assert [int(b["valid"].sum()) for b in batches] == [16] * 5 + [10]
    return batches


def test_cpu_stream_of_imagebert_b_yields_score_batch(tmp_path):
    """ImageBERT-B (S=30, key masks, the label conv; C runs the same forward) through a CPU engine's stream."""
    spec = get_model("imagebert_b", overrides=TINY)
    engine = ScoringEngine(spec, spec.init_params(3), device="cpu")
    batches = _imagebert_b_batches(tmp_path, spec)
    _assert_bit_equal(list(engine.score_stream(iter(batches))), [_alone(engine, b) for b in batches])


def test_cuda_graph_of_imagebert_b_replays_bit_equal(cuda, tmp_path):
    """ImageBERT-B's forward captures too (its positions are made on the device): six batches, two captures,
    four replays, each bit-equal to ``score_batch``."""
    spec = get_model("imagebert_b", overrides={"num_hidden_layers": 2})
    engine = ScoringEngine(spec, spec.init_params(3), device=cuda)
    batches = _imagebert_b_batches(tmp_path, spec)
    want = [_alone(engine, b) for b in batches]
    with profile(activities=[ProfilerActivity.CPU]):
        got = list(engine.score_stream(iter(batches)))
    _assert_bit_equal(got, want)
    assert _graph_counters() == {"engine.graph_captures": 2, "engine.graph_replays": 6 - 2}


@pytest.mark.parametrize("model", MODELS)
def test_cuda_graph_replays_bit_equal_on_the_f32_xla_route(cuda, model):
    """The f32 engine on the card (the plain "xla" route, TF32 off) takes the same rule, bit-equal."""
    spec = get_model(model, overrides=CARD_DEPTHS[model])
    engine = ScoringEngine(spec, spec.init_params(3), device=cuda, precision=Precision.f32())
    assert engine.attention_backend == "xla"
    batches = _batches(model, spec, [64] * 6, tail=33)
    want = [_alone(engine, b) for b in batches]
    with profile(activities=[ProfilerActivity.CPU]):
        got = list(engine.score_stream(iter(batches)))
    _assert_bit_equal(got, want)
    assert _graph_counters() == {"engine.graph_captures": 2, "engine.graph_replays": 6 - 2}


@pytest.mark.parametrize("model", MODELS)
def test_cuda_graph_captures_again_after_update_params(cuda, model):
    """New weights in the middle of a stream of ten batches, once the fifth (a replay) is issued: both graphs
    are dropped, so the batches after it are the new weights' ``score_batch``, and both slots run eagerly and
    capture again (four captures, six replays in all)."""
    engine, spec = _engine(model, cuda, CARD_DEPTHS)
    batches = _batches(model, spec, [64] * 10, tail=40)
    old = [_alone(engine, b) for b in batches]
    new_params = spec.init_params(5)
    with profile(activities=[ProfilerActivity.CPU]):
        stream = engine.score_stream(iter(batches))
        got = [next(stream) for _ in range(4)]  # the fifth batch is issued before the fourth's scores come
        assert all(s.graph is not None for s in engine._slots)
        engine.update_params(new_params)
        assert all(s.graph is None for s in engine._slots)
        got += list(stream)
    want = [_alone(engine, b) for b in batches]
    assert any(g.tobytes() != w.tobytes() for (_, _, g), (_, _, w) in zip(old, want))
    _assert_bit_equal(got, old[:5] + want[5:])
    assert _graph_counters() == {"engine.graph_captures": 4, "engine.graph_replays": 6}


@pytest.mark.parametrize("model", MODELS)
def test_cuda_graph_captures_again_when_the_batch_size_changes(cuda, model):
    """Six batches of 64 then six of 32 (its last padded): the slots capture at each size, bit-equal throughout."""
    engine, spec = _engine(model, cuda, CARD_DEPTHS)
    batches = _batches(model, spec, [64] * 6 + [32] * 6, tail=17)
    want = [_alone(engine, b) for b in batches]
    with profile(activities=[ProfilerActivity.CPU]):
        got = list(engine.score_stream(iter(batches)))
    _assert_bit_equal(got, want)
    assert _graph_counters() == {"engine.graph_captures": 4, "engine.graph_replays": 12 - 4}
    assert [s.layout[0][1][0] for s in engine._slots] == [32, 32]
