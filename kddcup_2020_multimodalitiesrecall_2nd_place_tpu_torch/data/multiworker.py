"""Multi-process host input pipeline: N worker processes feed one card (the
port of the JAX package's ``data/multiworker.py``).

The reference's ``GeneratorEnqueuer`` (``imagebert_lds/src/data_util.py``
:15-128) runs one Python generator in N processes with a per-worker seed
bump, so its batch stream depends on the worker count and on scheduling.
Here the input is chunked instead: workers parse and featurize fixed byte
spans of the files (split at line boundaries), and the consumer puts the
spans back in order and slices batches, so the batch stream is bit-identical
for every worker count, 0 (inline, no processes) included, and equal to the
per-example path's (``fast_pipeline.rebatch``).

Processes, not threads: the base64 and geometry decode is native and
releases the GIL, but WordPiece tokenization and the numpy assembly hold it.

Workers are started with the ``spawn`` method (a process that holds a CUDA
context is never forked), with ``CUDA_VISIBLE_DEVICES=""`` in their
environment, and without the parent's ``__main__``: a worker imports only
numpy and this package's ``data`` and ``tokenization`` modules, never
``torch``, and checks so before its first span.

A span's arrays travel through one POSIX shared-memory block (``use_shm``):
one copy in, in the worker, and one out, in the consumer, instead of
pickling ~82 KB a row of RoI features through a pipe. The blocks are named
``kmr_<worker pid>_<n>``, apart from the ``psm_*`` names of the standard
library's default. A span goes through the pickling queue instead when
``/dev/shm`` is full or missing.
"""

from __future__ import annotations

import contextlib
import itertools
import multiprocessing as mp
import os
import sys
import threading
import traceback
import types
from typing import Iterator

import numpy as np

from .fast_pipeline import chunk_spans, featurize_raw, rebatch
from .featurize import Featurizer, stack_examples
from .native import get_lib, parse_pairs_native
from .pipeline import PipelineStats, iter_examples

DEFAULT_CHUNK_BYTES = 32 << 20  # ~550 rows of testB-sized pairs
SHM_PREFIX = "kmr_"

_start_lock = threading.Lock()  # os.environ and sys.modules["__main__"] are process-wide
_shm_counter = itertools.count()


# ------------------------------------------------------------- shm transfer
# Lifecycle on 3.12 (no ``track=`` until 3.13): both opener sides register the
# block with the resource tracker, so the worker unregisters after filling it
# (the consumer owns the block from then on) and the consumer's ``unlink()``
# drops its own registration. A consumer killed hard can leak blocks;
# ``_spans_pooled``'s cleanup drains every queued or undelivered block on the
# normal and the error paths.

def _shm_pack(full: dict[str, np.ndarray]):
    """Copy a span's arrays into one shm block -> (name, metas)."""
    from multiprocessing import resource_tracker, shared_memory

    metas = []
    total = 0
    for k, v in full.items():
        metas.append((k, v.shape, v.dtype.str, total))
        total += int(v.nbytes)
    name = f"{SHM_PREFIX}{os.getpid()}_{next(_shm_counter)}"
    shm = shared_memory.SharedMemory(name=name, create=True, size=max(total, 1))
    try:
        for (k, shape, dt, off), v in zip(metas, full.values()):
            np.ndarray(shape, dtype=dt, buffer=shm.buf, offset=off)[...] = v
    except BaseException:
        shm.close()
        shm.unlink()  # unlink also drops the tracker registration
        raise
    # the consumer owns the block from here: drop this process's registration
    # so the worker's exit cannot reap a block the consumer is about to read
    resource_tracker.unregister(shm._name, "shared_memory")
    shm.close()
    return name, metas


def _shm_unpack(name: str, metas) -> dict[str, np.ndarray]:
    """Copy arrays out of a shm block and remove it."""
    from multiprocessing import shared_memory

    shm = shared_memory.SharedMemory(name=name)
    try:
        return {k: np.ndarray(shape, dtype=dt, buffer=shm.buf, offset=off).copy() for k, shape, dt, off in metas}
    finally:
        shm.close()
        shm.unlink()  # also drops the attach side's registration


def _shm_drop(name: str) -> None:
    """Remove an unconsumed block (the error and teardown paths)."""
    from multiprocessing import shared_memory

    try:
        shm = shared_memory.SharedMemory(name=name)
    except FileNotFoundError:
        return
    shm.close()
    with contextlib.suppress(FileNotFoundError):
        shm.unlink()


def _shm_sweep(pids) -> None:
    """Remove every block the given workers named (``kmr_<pid>_<n>``): those
    a worker packed but whose message died with it."""
    prefixes = tuple(f"{SHM_PREFIX}{pid}_" for pid in pids)
    with contextlib.suppress(FileNotFoundError):  # a host without /dev/shm
        for name in os.listdir("/dev/shm"):
            if name.startswith(prefixes):
                _shm_drop(name)


def featurize_span(path: str, start: int, end: int, featurizer: Featurizer, layout: str,
                   use_native: bool = True) -> tuple[dict[str, np.ndarray], int, int]:
    """Parse and featurize one byte span -> (its arrays, rows parsed, parse errors)."""
    with open(path, "rb") as f:
        f.seek(start)
        buf = f.read(end - start)
    if use_native:
        raw = parse_pairs_native(buf)
        return featurize_raw(raw, featurizer, layout), len(raw["product_id"]), int(raw["n_errors"])
    stats = PipelineStats()
    fz = featurizer.for_model(layout)
    rows = [fz(ex) for ex in iter_examples(buf.decode("utf-8").splitlines(), stats)]
    return (stack_examples(rows) if rows else {}), stats.parsed, stats.errors


def _worker_main(task_q, out_q, featurizer, layout, use_native, use_shm) -> None:
    """A worker's loop: byte spans in, featurized span arrays out."""
    try:
        if "torch" in sys.modules:
            raise RuntimeError("a loader worker imported torch; it must stay a numpy-only process")
        while True:
            item = task_q.get()
            if item is None:
                out_q.put(("done", None, None))
                return
            idx, path, start, end = item
            full, parsed, errors = featurize_span(path, start, end, featurizer, layout, use_native)
            if use_shm and full:
                try:
                    name, metas = _shm_pack(full)
                except OSError:  # /dev/shm full or missing: pickle this span
                    out_q.put(("chunk", idx, (full, parsed, errors)))
                else:
                    out_q.put(("shm", idx, (name, metas, parsed, errors)))
            else:
                out_q.put(("chunk", idx, (full, parsed, errors)))
    except BaseException:  # noqa: BLE001 -- the traceback goes to the consumer, which raises it
        out_q.put(("error", None, traceback.format_exc()))


@contextlib.contextmanager
def _worker_start_env():
    """While workers start: no CUDA device in their environment, and no
    ``__main__`` for ``spawn`` to import into them (the parent's main module,
    a CLI or a script, imports torch)."""
    with _start_lock:
        saved_env = os.environ.get("CUDA_VISIBLE_DEVICES")
        saved_main = sys.modules["__main__"]
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        sys.modules["__main__"] = types.ModuleType("__main__")
        try:
            yield
        finally:
            sys.modules["__main__"] = saved_main
            if saved_env is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES", None)
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = saved_env


class MultiWorkerLoader:
    """files -> fixed-shape batches, parsed and featurized by N processes.

    ``num_workers=0`` runs the same chunked path inline, without processes.
    ``use_native=True`` (the default) parses with the native library, built
    here if it is missing (a failed build raises ``NativeUnavailable``);
    ``use_native=False`` runs the per-example Python path in the workers.
    Iterating twice starts the workers again."""

    def __init__(self, paths, featurizer: Featurizer, layout: str, batch_size: int, num_workers: int = 2,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES, stats: PipelineStats | None = None,
                 use_native: bool = True, timeout: float = 600.0, use_shm: bool = True):
        if use_native:
            get_lib()  # build once here, not in every worker; raises if it cannot
        self.paths = [str(p) for p in paths]
        self.featurizer = featurizer
        self.layout = layout
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.chunk_bytes = chunk_bytes
        self.stats = stats if stats is not None else PipelineStats()
        self.use_native = use_native
        self.timeout = timeout
        self.use_shm = use_shm
        self.worker_pids: list[int] = []  # of the last pooled run

    def _spans_inline(self, spans) -> Iterator[dict]:
        for _, path, start, end in spans:
            full, parsed, errors = featurize_span(path, start, end, self.featurizer, self.layout, self.use_native)
            self.stats.parsed += parsed
            self.stats.errors += errors
            yield full

    def _spans_pooled(self, spans) -> Iterator[dict]:
        ctx = mp.get_context("spawn")
        task_q = ctx.Queue()
        out_q = ctx.Queue(maxsize=2 * self.num_workers)

        # Tasks are fed lazily, never more than max_ahead spans past the next
        # span the consumer needs: this bounds the reorder buffer (and so host
        # memory) even when one span parses much slower than its neighbours.
        max_ahead = 4 * self.num_workers
        sent = 0
        ended = False

        def feed(next_idx: int) -> None:
            nonlocal sent, ended
            while sent < len(spans) and sent < next_idx + max_ahead:
                task_q.put(spans[sent])
                sent += 1
            if sent == len(spans) and not ended:
                ended = True
                for _ in range(self.num_workers):
                    task_q.put(None)

        feed(0)
        procs = [
            ctx.Process(target=_worker_main, daemon=True,
                        args=(task_q, out_q, self.featurizer, self.layout, self.use_native, self.use_shm))
            for _ in range(self.num_workers)
        ]
        reorder: dict[int, tuple] = {}
        try:
            with _worker_start_env():
                for p in procs:
                    p.start()
            self.worker_pids = [p.pid for p in procs]
            next_idx = 0
            done = 0
            while done < self.num_workers or next_idx < len(spans):
                try:
                    kind, idx, payload = out_q.get(timeout=self.timeout)
                except Exception as e:  # queue.Empty
                    dead = [p.pid for p in procs if not p.is_alive()]
                    raise RuntimeError(f"loader stalled >{self.timeout}s waiting for span {next_idx}/{len(spans)} "
                                       f"(dead workers: {dead})") from e
                if kind == "error":
                    raise RuntimeError(f"loader worker failed:\n{payload}")
                if kind == "done":
                    done += 1
                    continue
                reorder[idx] = (kind, payload)
                while next_idx in reorder:
                    kind, payload = reorder.pop(next_idx)
                    if kind == "shm":
                        name, metas, parsed, errors = payload
                        full = _shm_unpack(name, metas)
                    else:
                        full, parsed, errors = payload
                    next_idx += 1
                    feed(next_idx)
                    self.stats.parsed += parsed
                    self.stats.errors += errors
                    yield full
        finally:
            for p in procs:
                if p.pid is not None:
                    p.terminate()
            for p in procs:
                if p.pid is not None:
                    p.join(timeout=10)
            # remove every block that never reached _shm_unpack
            for kind, payload in reorder.values():
                if kind == "shm":
                    _shm_drop(payload[0])
            with contextlib.suppress(Exception):  # queue.Empty, or closed
                while True:
                    kind, _, payload = out_q.get_nowait()
                    if kind == "shm":
                        _shm_drop(payload[0])
            _shm_sweep(p.pid for p in procs if p.pid is not None)

    def __iter__(self) -> Iterator[dict]:
        spans = [(i, *span) for i, span in enumerate(chunk_spans(self.paths, self.chunk_bytes))]
        if not spans:
            return iter(())
        fulls = self._spans_inline(spans) if self.num_workers == 0 else self._spans_pooled(spans)
        return rebatch(fulls, self.batch_size, self.stats)
