"""The scoring engine: streams TSV pairs through one model on one device.

Fixed batch shape (the tail padded, with a ``valid`` mask), parameters
resident on the device, and one batch in flight: batch N+1 is launched
before batch N's scores are copied back, so the host loader (behind a
prefetch thread: the native parser inline, N loader processes, or the
per-example Python path), the device and the copy overlap.

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
from ..data.multiworker import MultiWorkerLoader
from ..data.native import get_lib
from ..models import ModelSpec, Precision, two_tower
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


class ScoringEngine:
    """Pairwise scorer for one model on one device. Spans (``utils/observability.py``):
    ``score.files``, ``loader.wait``, ``engine.h2d``, ``engine.forward``, ``engine.d2h``;
    counter ``h2d.bytes``."""

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
        self.update_params(params)

    @torch.no_grad()
    def update_params(self, params) -> None:
        """Swap in new weights (a training run's valid pass), prepared as at
        construction: the MLM head left out, the matmul kernels cast to the
        compute dtype, the tree on the engine's device."""
        self.params = tree_to(cast_matmul_weights(scoring_params(params), self.precision.compute_dtype,
                                                  self.model.matmul_kernels), self.device)

    def to_device(self, batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        with span("engine.h2d"):
            out = {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(self.device) for k in self.model.input_keys}
        if tracing():
            count("h2d.bytes", sum(t.nbytes for t in out.values()))
        return out

    @torch.inference_mode()
    def score_batch(self, batch: dict[str, np.ndarray]) -> torch.Tensor:
        """-> f32 scores [B] on the device (not yet synchronised)."""
        feats = self.to_device(batch)
        with span("engine.forward"), attention.attention_backend(self.attention_backend):
            return self.model.apply(self.params, feats, self.model.config, self.precision)["score"]

    def score_stream(
        self, batches: Iterable[dict], stats: ScoringStats | None = None
    ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """-> (query_ids, product_ids, scores) per batch, valid rows only;
        span ``loader.wait`` is the time blocked on ``batches`` for each."""
        stats = stats if stats is not None else ScoringStats()
        pending = None  # (qid, pid, valid, device_scores)
        batches = iter(batches)
        while True:
            with span("loader.wait"):
                batch = next(batches, None)
            if batch is None:
                break
            scores = self.score_batch(batch)
            if pending is not None:
                yield self._finish(pending, stats)
            pending = (batch["query_id"], batch["product_id"], batch["valid"], scores)
        if pending is not None:
            yield self._finish(pending, stats)

    @staticmethod
    def _finish(pending, stats: ScoringStats):
        qid, pid, valid, scores = pending
        with span("engine.d2h"):
            scores = scores.float().cpu().numpy()[valid]  # waits for this batch only
        stats.pairs += int(valid.sum())
        stats.batches += 1
        return qid[valid], pid[valid], scores

    def score_files(
        self, paths, featurizer: Featurizer, batch_size: int, stats: ScoringStats | None = None,
        use_native: bool = True, num_workers: int = 0,
    ) -> dict[str, dict[str, float]]:
        """Full scorer run: files -> {query_id: {product_id: score}}.

        The host loader, each behind a prefetch thread, yields the same batches
        bit for bit: ``num_workers > 0`` parses and featurizes in that many
        worker processes (``data/multiworker.py``); otherwise ``use_native``
        (the default) parses with the native library inline, byte span by
        byte span on a pool of threads (``data/fast_pipeline.py``), and
        ``use_native=False`` runs the
        per-example Python path. A native library that cannot be built raises;
        no loader is swapped for another."""
        stats = stats if stats is not None else ScoringStats()
        with span("score.files"):
            layout = self.model.featurizer_layout
            if num_workers:
                loader = MultiWorkerLoader(paths, featurizer, layout, batch_size, num_workers=num_workers,
                                           stats=stats.pipeline, use_native=use_native)
                batches = PrefetchIterator(iter(loader), prefetch=4)
            elif use_native:
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
