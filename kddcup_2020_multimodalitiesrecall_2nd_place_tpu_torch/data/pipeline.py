"""Host-side input pipeline: TSV stream -> fixed-shape numpy batches.

A bounded-queue background thread featurizes batch N+k while the device
scores batch N. End of data is explicit, and parse errors are counted per
line instead of ending the stream. Batches have one shape (tail padded, with
a ``valid`` mask).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator

import numpy as np

from .featurize import pad_batch, stack_examples
from .tsv import RawExample, is_header, parse_line


@dataclass
class PipelineStats:
    lines: int = 0
    parsed: int = 0
    errors: int = 0
    batches: int = 0
    error_examples: list[str] = field(default_factory=list)


def iter_examples(
    lines: Iterable[str], stats: PipelineStats | None = None
) -> Iterator[RawExample]:
    stats = stats if stats is not None else PipelineStats()
    for line in lines:
        stats.lines += 1
        if is_header(line) or not line.strip():
            continue
        try:
            ex = parse_line(line)
        except (ValueError, IndexError):  # malformed row: count it, keep going
            stats.errors += 1
            if len(stats.error_examples) < 8:
                stats.error_examples.append(line[:200])
            continue
        stats.parsed += 1
        yield ex


def iter_batches(
    lines: Iterable[str],
    featurize: Callable[[RawExample], dict[str, np.ndarray]],
    batch_size: int,
    stats: PipelineStats | None = None,
) -> Iterator[dict[str, np.ndarray]]:
    """Synchronous featurize + batch. The tail batch is padded with a mask."""
    stats = stats if stats is not None else PipelineStats()
    buf: list[dict[str, np.ndarray]] = []
    for ex in iter_examples(lines, stats):
        buf.append(featurize(ex))
        if len(buf) == batch_size:
            stats.batches += 1
            yield pad_batch(stack_examples(buf), batch_size)
            buf = []
    if buf:
        stats.batches += 1
        yield pad_batch(stack_examples(buf), batch_size)


class PrefetchIterator:
    """Runs an iterator on a daemon thread with a bounded queue; exceptions
    raised by the producer are raised again in the consumer."""

    _DONE = object()

    def __init__(self, it: Iterator, prefetch: int = 4):
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._err: BaseException | None = None
        self._thread = threading.Thread(target=self._run, args=(it,), daemon=True)
        self._thread.start()

    def _run(self, it: Iterator) -> None:
        try:
            for item in it:
                self._queue.put(item)
        except BaseException as e:  # handed to the consumer, which re-raises it
            self._err = e
        finally:
            self._queue.put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def batches_from_files(
    paths: Iterable,
    featurize: Callable[[RawExample], dict[str, np.ndarray]],
    batch_size: int,
    stats: PipelineStats | None = None,
    prefetch: int = 4,
) -> Iterator[dict[str, np.ndarray]]:
    def _lines():
        for path in paths:
            with open(path, "r", encoding="utf-8") as f:
                yield from f

    it = iter_batches(_lines(), featurize, batch_size, stats=stats)
    return PrefetchIterator(it, prefetch=prefetch) if prefetch else it
