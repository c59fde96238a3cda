"""ctypes binding of the native TSV parser (``preproc.cpp``), built with g++ at first use.

The library lands in ``build/native/libpreproc-<hash>.so`` of the checkout,
never next to its source. The hash covers the source, the compiler flags, the
compiler's version and the host's machine type, so an edited source, or a
``build/`` directory carried to another host, is rebuilt and a stale library
is never loaded. Each process that builds it compiles to a name of its own and
moves the result in place with ``os.replace``: processes that build at once
(the test suite's workers) each see either no library or a whole one.

The flags leave out ``-march=native``: a checkout's ``build/`` directory may be
copied to another host with another CPU, where a library tuned for the first
could fault on an instruction the second lacks.

A failed build raises ``NativeUnavailable``; nothing falls back to the Python
parser on its own (the caller chooses ``use_native=False`` for that).
"""

from __future__ import annotations

import concurrent.futures as cf
import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

from ... import BUILD_DIR, PACKAGE_ROOT

SOURCE = PACKAGE_ROOT / "data" / "native" / "preproc.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
MAX_BOXES = 10
FEAT_DIM = 2048

_lock = threading.Lock()
_lib = None


class NativeUnavailable(RuntimeError):
    pass


@functools.lru_cache(maxsize=1)
def _compiler() -> str:
    """g++'s version ("" without g++: the build then raises)."""
    try:
        return subprocess.run(["g++", "-dumpfullversion"], capture_output=True, text=True, check=True).stdout
    except (FileNotFoundError, subprocess.CalledProcessError):
        return ""


def library_path():
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode() + _compiler().encode() + platform.machine().encode()
    ).hexdigest()[:12]
    return BUILD_DIR / "native" / f"libpreproc-{digest}.so"


def build() -> None:
    """Compile the library unless it is there; raises NativeUnavailable."""
    target = library_path()
    if target.is_file():
        return
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)], check=True, capture_output=True,
                       text=True)
    except FileNotFoundError as e:
        raise NativeUnavailable(f"cannot build the native parser: g++ not found ({e})") from e
    except subprocess.CalledProcessError as e:
        tmp.unlink(missing_ok=True)
        raise NativeUnavailable(f"cannot build the native parser:\n{e.stderr}") from e
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing


def get_lib():
    """The bound library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        build()
        lib = ctypes.CDLL(str(library_path()))
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.parse_pairs.restype = ctypes.c_int64
        lib.parse_pairs.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, i64p, i64p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            i64p, i64p, i64p, i64p,
        ]
        lib.count_rows.restype = ctypes.c_int64
        lib.count_rows.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        _lib = lib
        return lib


def count_rows(buf: bytes) -> int:
    """Data rows (non-empty, non-header lines) of a TSV buffer."""
    return int(get_lib().count_rows(buf, len(buf)))


def _split_at_lines(buf: bytes, n_chunks: int) -> list[bytes]:
    """Split a buffer into ~equal chunks on line boundaries (one chunk below 1 MB)."""
    if n_chunks <= 1 or len(buf) < 1 << 20:
        return [buf]
    chunks = []
    start = 0
    step = len(buf) // n_chunks
    for _ in range(1, n_chunks):
        cut = buf.find(b"\n", min(start + step, len(buf) - 1))
        if cut == -1:
            break
        chunks.append(buf[start : cut + 1])
        start = cut + 1
    chunks.append(buf[start:])
    return [c for c in chunks if c]


def parse_pairs_native(buf: bytes, n_threads: int | None = None) -> dict:
    """Parse a whole TSV buffer into dense arrays (see ``preproc.cpp``):
    product_id, query_id, num_boxes, boxes5, boxes4, features, class_labels,
    the query strings and n_errors, the rows that failed to parse.

    The C call releases the GIL, so a buffer over 1 MB is split at line
    boundaries and parsed by a thread pool; the parts join in order."""
    n_threads = n_threads if n_threads is not None else min(8, os.cpu_count() or 1)
    chunks = _split_at_lines(buf, n_threads)
    if len(chunks) == 1:
        return _parse_single(buf)
    with cf.ThreadPoolExecutor(max_workers=len(chunks)) as pool:
        parts = list(pool.map(_parse_single, chunks))
    out: dict = {}
    for k in parts[0]:
        if k == "n_errors":
            out[k] = sum(p[k] for p in parts)
        elif k == "queries":
            out[k] = [q for p in parts for q in p[k]]
        else:
            out[k] = np.concatenate([p[k] for p in parts], axis=0)
    return out


def _parse_single(buf: bytes) -> dict:
    lib = get_lib()
    n = int(lib.count_rows(buf, len(buf)))
    out = {
        "product_id": np.empty(n, np.int64),
        "query_id": np.empty(n, np.int64),
        "num_boxes": np.empty(n, np.int32),
        "boxes5": np.empty((n, MAX_BOXES, 5), np.float32),
        "boxes4": np.empty((n, MAX_BOXES, 4), np.float32),
        "features": np.empty((n, MAX_BOXES, FEAT_DIM), np.float32),
        "class_labels": np.empty((n, MAX_BOXES), np.int64),
    }
    query_off = np.empty(n, np.int64)
    query_len = np.empty(n, np.int64)
    n_errors = np.zeros(1, np.int64)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    rows = int(lib.parse_pairs(
        buf, len(buf), n,
        ptr(out["product_id"], ctypes.c_int64), ptr(out["query_id"], ctypes.c_int64),
        ptr(out["num_boxes"], ctypes.c_int32), ptr(out["boxes5"], ctypes.c_float),
        ptr(out["boxes4"], ctypes.c_float), ptr(out["features"], ctypes.c_float),
        ptr(out["class_labels"], ctypes.c_int64), ptr(query_off, ctypes.c_int64),
        ptr(query_len, ctypes.c_int64), ptr(n_errors, ctypes.c_int64),
    ))
    result = {k: v[:rows] for k, v in out.items()}
    result["queries"] = [
        buf[query_off[i] : query_off[i] + query_len[i]].decode("utf-8", "replace") for i in range(rows)
    ]
    result["n_errors"] = int(n_errors[0])
    return result
