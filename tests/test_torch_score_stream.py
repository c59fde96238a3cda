"""``ScoringEngine.score_stream`` against ``score_batch`` on each batch alone, for ImageBERT-A and LXMERT.

On the CPU the stream scores each batch through ``score_batch`` and keeps no ring. On the card it stages each
batch through its two-slot pinned ring, copies it in on a side stream and reads its scores back through pinned
memory; the scores are bit-equal to ``score_batch``'s on the same batch: over batches of different contents
with a padded tail, with a caller that overwrites its arrays in place once asked for the next batch, and with
shapes that change between batches (the slots' buffers made again); traced, ``h2d.pinned_bytes`` equals
``h2d.bytes``. The card's tests take the ``cuda`` fixture and skip without a GPU. The file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_score_stream.py
"""

from collections import Counter

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import get_model
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.parallel import ScoringEngine, ScoringStats
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
    assert rec["counters"] == {"h2d.bytes": want, "h2d.pinned_bytes": want}
