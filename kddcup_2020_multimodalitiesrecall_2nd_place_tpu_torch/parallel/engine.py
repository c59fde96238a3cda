"""The scoring engine: streams TSV pairs through one model on one device.

Fixed batch shape (the tail padded, with a ``valid`` mask), parameters
resident on the device, and one batch in flight: batch N+1 is launched
before batch N's scores are read back, so the host loader (the native
parser on a prefetch thread, or the per-example Python path) overlaps the
device. On CUDA, ``score_stream``
also takes the copies off the compute stream, through a ring of two slots
(``_Slot``): each batch is staged into a slot's pinned host buffers while
the device runs the previous forward, copied to the slot's device buffers
on a side stream that the forward waits for, and its scores are copied
into pinned memory right after its own forward, ahead of the next one. So
batch N+1's copy runs beside batch N's forward, and reading N's scores
waits for N's forward alone. Each slot also replays the forward as one CUDA
graph that reads its device buffers, so the host enqueues a batch in one
launch rather than a hundred (``graph_phase``): a layout's first batch in a
slot runs eagerly, which warms the kernels' builds and lazy state, its
second is captured and then replayed, and every later one is replayed. A
new layout in the slot (shapes, dtypes, the attention backend or a route
switch the forward reads), or new weights (``update_params``), starts the
slot over. The graphs live for one ``score_stream``, so one ``score_files``
pass: when the stream ends they are dropped and the memory pool they shared
is given back to the device, so that a training run does not hold it
between its valid passes. A CPU engine, and ``score_batch`` (one call,
nothing to overlap), copy and run as before.

Device policy: the engine runs on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no explicit ``cpu`` it raises, and it
never moves to the CPU on its own.

Attention backend (``ops/attention.py``), scoped around every batch: the
caller's choice of "xla", "pallas" or "pallas_packed", or by default the JAX
engine's rule (``parallel/engine.py`` :79-85): "pallas_packed", the fused
blocks of hand-written kernels, on CUDA in bf16; "xla", the plain unfused
route, in f32 or on the CPU. So f32 on CUDA runs plain f32 products with TF32
off (``Precision.f32()``), a choice recorded in ``engine.attention_backend``;
nothing falls back when a kernel fails to build or launch. On the CPU every
kernel wrapper runs its plain version.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Iterable, Iterator

import numpy as np
import torch

from ..checkpoint.npz import cast_matmul_weights, scoring_params, tree_to
from ..data import Featurizer, PipelineStats, PrefetchIterator, batches_from_files
from ..data.fast_pipeline import native_batches_from_files
from ..data.native import get_lib
from ..models import ModelSpec, Precision, two_tower
from ..models.core import route_key
from ..ops import attention
from ..utils.observability import count, span, tracing


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means CUDA. Raises rather than running elsewhere than asked."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was asked for (the default) but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def default_precision(device: torch.device) -> Precision:
    return Precision.bf16() if device.type == "cuda" else Precision.f32()


def default_attention_backend(device: torch.device, precision: Precision) -> str:
    """"pallas_packed" on CUDA in bf16, "xla" in f32 or on the CPU."""
    return "pallas_packed" if device.type == "cuda" and precision.compute_dtype != torch.float32 else "xla"


@dataclass
class ScoringStats:
    pairs: int = 0
    batches: int = 0
    seconds: float = 0.0
    pipeline: PipelineStats = field(default_factory=PipelineStats)

    @property
    def pairs_per_second(self) -> float:
        return self.pairs / self.seconds if self.seconds > 0 else 0.0


def layout_key(inputs: dict[str, torch.Tensor], attention_backend: str) -> tuple:
    """What a ring slot's buffers and graph are made for: each input's key, shape and dtype, then the
    attention backend and the route switches as the forward would read them now (``models/core.py:route_key``)."""
    return (*((k, t.shape, t.dtype) for k, t in inputs.items()), ("attention_backend", attention_backend),
            *route_key())


def graph_phase(held: tuple | None, layout: tuple, runs: int) -> tuple[str, int]:
    """The capture rule of a ring slot that holds layout ``held`` and has run ``runs`` batches of it, for a
    batch of ``layout`` -> ("eager", "capture" or "replay", the slot's batches of ``layout`` with this one).
    Eager where ``layout`` is new to the slot, capture on its second batch, replay from the third."""
    runs = runs + 1 if layout == held else 1
    return ("eager", "capture", "replay")[min(runs, 3) - 1], runs


class _Slot:
    """One slot of ``score_stream``'s ring on CUDA: pinned host and device buffers for a batch's inputs (made
    for one ``layout_key``, and made again when it changes), a pinned buffer for its scores, the events that
    order their reuse, and the CUDA graph of the forward on its device buffers."""

    def __init__(self):
        self.layout = None
        self.host: dict[str, torch.Tensor] = {}
        self.device: dict[str, torch.Tensor] = {}
        self.scores: torch.Tensor | None = None
        self.copied_in = torch.cuda.Event()  # the H2D from ``host`` into ``device`` is done
        self.consumed = torch.cuda.Event()  # the forward that read ``device`` is done
        self.copied_out = torch.cuda.Event()  # the scores are in ``scores``
        self.drop_graph()

    def drop_graph(self) -> None:
        """Forget the graph (its inputs or weights are gone) and start the layout's count over."""
        self.runs = 0  # batches of ``layout`` run since it came or the graph was dropped
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out: torch.Tensor | None = None  # the graph's scores, in the pool the slots' graphs share


class ScoringEngine:
    """Pairwise scorer for one model on one device. Spans (``utils/observability.py``):
    ``score.files``, ``loader.wait``, ``engine.h2d``, ``engine.forward``, ``engine.d2h``, each
    once a batch; counters ``h2d.bytes`` (the batches' input tensors) and, on CUDA in
    ``score_stream``, ``h2d.pinned_bytes`` (those of them staged through the pinned ring),
    ``engine.graph_captures`` and ``engine.graph_replays`` (the slots' graphs)."""

    def __init__(self, model: ModelSpec, params, device=None, precision: Precision | None = None,
                 attention_backend: str | None = None):
        self.model = model
        self.device = resolve_device(device)
        self.precision = precision if precision is not None else default_precision(self.device)
        if attention_backend is None:
            attention_backend = default_attention_backend(self.device, self.precision)
        if attention_backend not in attention.BACKENDS:
            raise ValueError(f"unknown attention backend {attention_backend!r}, expected one of "
                             f"{attention.BACKENDS}")
        self.attention_backend = attention_backend
        self._copy_stream = None  # CUDA: the side stream of score_stream's H2D, and its two slots
        self._slots: tuple[_Slot, _Slot] | None = None
        self._capture_stream = None  # CUDA: the stream the slots' graphs are captured on, and their memory pool
        self._graph_pool = None
        self.update_params(params)

    @torch.no_grad()
    def update_params(self, params) -> None:
        """Swap in new weights (a training run's valid pass), prepared as at
        construction: the MLM head left out, the matmul kernels cast to the
        compute dtype, the tree on the engine's device. The ring's graphs,
        which read the old weights, are dropped."""
        self._drop_graphs()
        self.params = tree_to(cast_matmul_weights(scoring_params(params), self.precision.compute_dtype,
                                                  self.model.matmul_kernels), self.device)

    def _drop_graphs(self) -> None:
        """Forget both slots' graphs and give the memory pool they shared back to the device."""
        held = any(slot.graph is not None for slot in self._slots or ())
        for slot in self._slots or ():
            slot.drop_graph()
        if held:
            # a pool no graph holds is freed only by the allocator's release of its unused blocks
            torch.cuda.empty_cache()

    def to_device(self, batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        with span("engine.h2d"):
            out = {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(self.device) for k in self.model.input_keys}
        if tracing():
            count("h2d.bytes", sum(t.nbytes for t in out.values()))
        return out

    def _apply(self, feats: dict[str, torch.Tensor]) -> torch.Tensor:
        with attention.attention_backend(self.attention_backend):
            return self.model.apply(self.params, feats, self.model.config, self.precision)["score"]

    @torch.inference_mode()
    def _forward(self, feats: dict[str, torch.Tensor]) -> torch.Tensor:
        with span("engine.forward"):
            return self._apply(feats)

    @torch.inference_mode()
    def _replay(self, slot: _Slot, feats: dict[str, torch.Tensor], capture: bool) -> torch.Tensor:
        """The forward as ``slot``'s graph, on the compute stream; with ``capture`` the graph is captured
        first, on the capture stream into the pool the slots share (a new pool where no graph holds the
        last). The kernels' wrappers count the launches the capture records, and none of a replay's. -> the
        graph's scores, which the next replay of either slot's graph may overwrite."""
        with span("engine.forward"):
            if capture:
                if all(s.graph is None for s in self._slots):
                    self._graph_pool = torch.cuda.graph_pool_handle()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.stream(self._capture_stream):
                    # thread-local: another thread of the caller's may call CUDA meanwhile
                    graph.capture_begin(pool=self._graph_pool, capture_error_mode="thread_local")
                    try:
                        out = self._apply(feats)
                    finally:
                        graph.capture_end()
                slot.graph, slot.out = graph, out
                count("engine.graph_captures")
            slot.graph.replay()
            count("engine.graph_replays")
            return slot.out

    @torch.inference_mode()
    def score_batch(self, batch: dict[str, np.ndarray]) -> torch.Tensor:
        """-> f32 scores [B] on the device (not yet synchronised)."""
        return self._forward(self.to_device(batch))

    def _stage(self, slot: _Slot, batch: dict[str, np.ndarray]) -> tuple[dict[str, torch.Tensor], str, int]:
        """The batch's inputs into ``slot``: copied into its pinned buffers on the host (torch's intra-op
        threads; done on return, so the caller may reuse its arrays), then issued to its device buffers on
        the copy stream, which the compute stream waits for. -> the device buffers, and ``graph_phase``'s
        phase and count for the batch."""
        compute, copy = torch.cuda.current_stream(self.device), self._copy_stream
        with span("engine.h2d"):
            src = {k: torch.from_numpy(np.ascontiguousarray(batch[k])) for k in self.model.input_keys}
            slot.copied_in.synchronize()  # the slot's last H2D has read its pinned buffers
            layout = layout_key(src, self.attention_backend)
            phase, runs = graph_phase(slot.layout, layout, slot.runs)
            if layout != slot.layout:
                # a fresh device buffer may be memory that work queued on the compute stream still uses
                copy.wait_stream(compute)
                slot.drop_graph()
                slot.host = {k: torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for k, t in src.items()}
                slot.device = {k: torch.empty(t.shape, dtype=t.dtype, device=self.device) for k, t in src.items()}
                slot.layout = layout
            for k, t in src.items():
                slot.host[k].copy_(t)
            with torch.cuda.stream(copy):
                copy.wait_event(slot.consumed)  # the forward that last read the device buffers is done
                for k, t in slot.host.items():
                    slot.device[k].copy_(t, non_blocking=True)
                slot.copied_in.record(copy)
            compute.wait_event(slot.copied_in)
        if tracing():
            copied = sum(t.nbytes for t in slot.device.values())
            count("h2d.bytes", copied)
            count("h2d.pinned_bytes", copied)
        return slot.device, phase, runs

    def _score_pinned(self, slot: _Slot, batch: dict[str, np.ndarray]) -> tuple:
        """Stage, forward (eagerly, or as the slot's graph) and queue the scores' copy into ``slot``'s pinned
        buffer, ahead of the next forward. -> ``_finish``'s pending tuple, the ids and mask copied so the
        caller may reuse its arrays."""
        compute = torch.cuda.current_stream(self.device)
        feats, phase, runs = self._stage(slot, batch)
        scores = self._forward(feats) if phase == "eager" else self._replay(slot, feats, phase == "capture")
        slot.runs = runs  # counted once issued: after a capture that raised, the next batch captures again
        slot.consumed.record(compute)
        if slot.scores is None or slot.scores.shape != scores.shape or slot.scores.dtype != scores.dtype:
            slot.scores = torch.empty(scores.shape, dtype=scores.dtype, pin_memory=True)
        slot.scores.copy_(scores, non_blocking=True)
        slot.copied_out.record(compute)
        return (np.array(batch["query_id"]), np.array(batch["product_id"]), np.array(batch["valid"]),
                slot.scores, slot.copied_out)

    def score_stream(
        self, batches: Iterable[dict], stats: ScoringStats | None = None
    ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """-> (query_ids, product_ids, scores) per batch, valid rows only;
        span ``loader.wait`` is the time blocked on ``batches`` for each.
        On CUDA each batch goes through the next slot of the two-slot ring
        (``_score_pinned``), replayed as the slot's graph once its layout
        has come twice in this stream; on the CPU through ``score_batch``.
        The graphs are dropped when the stream ends, however it ends."""
        stats = stats if stats is not None else ScoringStats()
        if self.device.type == "cuda" and self._slots is None:
            self._copy_stream = torch.cuda.Stream(self.device)
            self._capture_stream = torch.cuda.Stream(self.device)
            self._slots = (_Slot(), _Slot())
        pending = None  # _finish's (qid, pid, valid, scores, event the scores' copy records or None)
        batches = iter(batches)
        n = 0
        try:
            while True:
                with span("loader.wait"):
                    batch = next(batches, None)
                if batch is None:
                    break
                if self.device.type == "cuda":
                    current = self._score_pinned(self._slots[n % 2], batch)
                else:
                    current = (batch["query_id"], batch["product_id"], batch["valid"], self.score_batch(batch), None)
                n += 1
                if pending is not None:
                    yield self._finish(pending, stats)
                pending = current
            if pending is not None:
                yield self._finish(pending, stats)
        finally:
            self._drop_graphs()

    @staticmethod
    def _finish(pending, stats: ScoringStats):
        qid, pid, valid, scores, copied_out = pending
        with span("engine.d2h"):
            if copied_out is not None:
                copied_out.synchronize()  # this batch's forward and its scores' copy; the next forward runs on
            scores = scores.float().cpu().numpy()[valid]
        stats.pairs += int(valid.sum())
        stats.batches += 1
        return qid[valid], pid[valid], scores

    def score_files(
        self, paths, featurizer: Featurizer, batch_size: int, stats: ScoringStats | None = None,
        use_native: bool = True,
    ) -> dict[str, dict[str, float]]:
        """Full scorer run: files -> {query_id: {product_id: score}}.

        The two host loaders yield the same batches bit for bit: ``use_native``
        (the default) parses with the native library, byte span by byte span
        on a pool of threads (``data/fast_pipeline.py``), behind a prefetch
        thread; ``use_native=False`` runs the per-example Python path, the
        reference. A native library that cannot be built raises; no loader is
        swapped for another."""
        stats = stats if stats is not None else ScoringStats()
        with span("score.files"):
            layout = self.model.featurizer_layout
            if use_native:
                get_lib()  # built here, so a failure raises before the prefetch thread starts
                batches = PrefetchIterator(native_batches_from_files(paths, featurizer, layout, batch_size,
                                                                     stats=stats.pipeline), prefetch=4)
            else:
                batches = batches_from_files(paths, featurizer.for_model(layout), batch_size, stats=stats.pipeline)
            result: dict[str, dict[str, float]] = {}
            t0 = time.perf_counter()
            for qids, pids, scores in self.score_stream(batches, stats):
                for q, p, s in zip(qids, pids, scores):
                    result.setdefault(str(q), {})[str(p)] = float(s)
            stats.seconds = time.perf_counter() - t0
            return result


class TowerEngine(ScoringEngine):
    """The two embedders of a two-tower spec on one device (its weights
    prepared, and its attention backend scoped around every batch, as
    ``ScoringEngine`` does; ``score_batch`` scores a pair's cosine)."""

    def side_to_device(self, side: str, batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        """The entries of a host batch that the ``side`` tower reads, on the device."""
        return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(self.device) for k in two_tower.SIDES[side][1]}

    @torch.inference_mode()
    def embed(self, side: str, batch: dict[str, np.ndarray]) -> torch.Tensor:
        """``side`` "query" or "product" over a host batch -> f32 unit embeddings [B, D] on the device (not yet
        synchronised)."""
        feats = self.side_to_device(side, batch)
        with attention.attention_backend(self.attention_backend):
            return two_tower.SIDES[side][0](self.params, feats, self.model.config, self.precision)


def write_scores_tsv(result: dict[str, dict[str, float]], path) -> None:
    """qid\\tpid\\tscore rows (the ImageBERT score-file format)."""
    with open(path, "w", encoding="utf-8") as f:
        for qid, row in result.items():
            for pid, s in row.items():
                f.write(f"{qid}\t{pid}\t{s}\n")


def write_scores_csv(result: dict[str, dict[str, float]], path) -> None:
    """The LXMERT score-file format: a ``query-id,product-id,score`` header,
    then qid,pid,score rows (the JAX package's ``parallel/engine.py`` :258-264)."""
    with open(path, "w", encoding="utf-8") as f:
        f.write("query-id,product-id,score\n")
        for qid, row in result.items():
            for pid, s in row.items():
                f.write(f"{qid},{pid},{s}\n")
