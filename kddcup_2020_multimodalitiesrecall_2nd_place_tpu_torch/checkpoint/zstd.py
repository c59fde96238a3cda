"""zstd frames through the system's ``libzstd`` (``ctypes``), for the orbax
reader: the port needs neither the ``zstandard`` package nor tensorstore.

* ``decompress_into``: one frame (or several, back to back) into a buffer of
  known size, a zarr chunk's ``prod(chunks) * itemsize`` bytes. tensorstore
  writes its chunks as frames that carry no content size, so the size comes
  from the caller.
* ``decompress``: a frame of unknown size (an OCDBT node), streamed with
  ``ZSTD_decompressStream`` and bounded by the caller's limit (the store's
  ``max_decoded_node_bytes``).
* ``compress``: one frame at a level (1 by default, as tensorstore writes
  zarr chunks), for the numpy-only test writer.

The library is found with ``ctypes.util.find_library("zstd")``, else loaded
as ``libzstd.so.1``; where neither loads, every call raises
``ZstdUnavailable`` naming it. There is no second decoder.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import threading

import numpy as np

LIBRARY = "libzstd.so.1"


class ZstdUnavailable(RuntimeError):
    pass


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


_lib = None
_lock = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded ``libzstd``, its functions declared (loaded once a process)."""
    global _lib
    with _lock:
        if _lib is None:
            name = ctypes.util.find_library("zstd") or LIBRARY
            try:
                # RTLD_DEEPBIND: the library's calls into itself bind to its own symbols, not to another zstd
                # a process already exports (TensorFlow's, loaded first, broke ZSTD_decompressStream's state)
                lib = ctypes.CDLL(name, mode=os.RTLD_LOCAL | getattr(os, "RTLD_DEEPBIND", 0))
            except OSError as e:
                raise ZstdUnavailable(
                    f"the orbax reader decodes zstd through the system's {LIBRARY} (libzstd1), "
                    f"which did not load ({name}): {e}") from e
            size_t, ptr = ctypes.c_size_t, ctypes.c_void_p
            for fn, res, args in (
                    ("ZSTD_versionNumber", ctypes.c_uint, []),
                    ("ZSTD_isError", ctypes.c_uint, [size_t]),
                    ("ZSTD_getErrorName", ctypes.c_char_p, [size_t]),
                    ("ZSTD_decompress", size_t, [ptr, size_t, ptr, size_t]),
                    ("ZSTD_compressBound", size_t, [size_t]),
                    ("ZSTD_compress", size_t, [ptr, size_t, ptr, size_t, ctypes.c_int]),
                    ("ZSTD_createDStream", ptr, []),
                    ("ZSTD_freeDStream", size_t, [ptr]),
                    ("ZSTD_initDStream", size_t, [ptr]),
                    ("ZSTD_decompressStream", size_t, [ptr, ctypes.POINTER(_OutBuffer), ctypes.POINTER(_InBuffer)])):
                f = getattr(lib, fn)
                f.restype, f.argtypes = res, args
            _lib = lib
    return _lib


def version() -> str:
    """``libzstd``'s version, ``major.minor.patch``."""
    n = library().ZSTD_versionNumber()
    return f"{n // 10000}.{n // 100 % 100}.{n % 100}"


def _check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd: {what}: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def _pointer(buf) -> tuple[int, int, object]:
    """(address, size, the object that keeps it alive) of a contiguous byte buffer."""
    arr = np.frombuffer(buf, np.uint8) if not isinstance(buf, np.ndarray) else buf
    if not arr.flags.c_contiguous:
        raise ValueError("zstd: the buffer must be contiguous")
    return arr.ctypes.data, arr.nbytes, arr


def decompress_into(frame, out: np.ndarray) -> None:
    """Decode ``frame`` (bytes, a memoryview or a uint8 array) into ``out``, a
    C-contiguous array whose bytes it fills exactly; anything else raises."""
    lib = library()
    src, n, _keep = _pointer(frame)
    if not out.flags.c_contiguous or not out.flags.writeable:
        raise ValueError("zstd: the output must be a writeable C-contiguous array")
    got = _check(lib, lib.ZSTD_decompress(out.ctypes.data, out.nbytes, src, n), "decompress")
    if got != out.nbytes:
        raise ValueError(f"zstd: a frame of {got} bytes where {out.nbytes} were expected")


def decompress(frame, limit: int) -> bytes:
    """Decode a frame of unknown size; more than ``limit`` bytes raise."""
    lib = library()
    src, n, _keep = _pointer(frame)
    stream = lib.ZSTD_createDStream()
    if not stream:
        raise MemoryError("zstd: ZSTD_createDStream failed")
    try:
        _check(lib, lib.ZSTD_initDStream(stream), "initDStream")
        inp = _InBuffer(src, n, 0)
        parts, total, step = [], 0, max(1 << 16, min(4 * n, limit + 1))
        while True:
            chunk = np.empty(step, np.uint8)
            out = _OutBuffer(chunk.ctypes.data, step, 0)
            left = _check(lib, lib.ZSTD_decompressStream(stream, ctypes.byref(out), ctypes.byref(inp)),
                          "decompressStream")
            parts.append(chunk[:out.pos].tobytes())
            total += out.pos
            if total > limit:
                raise ValueError(f"zstd: a node decodes to more than its limit of {limit} bytes")
            if left == 0 and inp.pos == n:
                return b"".join(parts)
            if inp.pos == n and out.pos < step:  # all input read, output room left, frame not done
                raise ValueError("zstd: the frame is truncated")
    finally:
        lib.ZSTD_freeDStream(stream)


def compress(data, level: int = 1) -> bytes:
    """One frame of ``data`` at ``level``."""
    lib = library()
    src, n, _keep = _pointer(data)
    cap = lib.ZSTD_compressBound(n)
    out = np.empty(cap, np.uint8)
    got = _check(lib, lib.ZSTD_compress(out.ctypes.data, cap, src, n, level), "compress")
    return out[:got].tobytes()
