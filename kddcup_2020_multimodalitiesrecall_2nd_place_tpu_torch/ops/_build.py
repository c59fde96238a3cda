"""Build the CUDA kernels of ``csrc/`` with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library ``build/kernels/<name>-<hash>.so``, where the hash covers the source,
every header of ``csrc/`` (``*.cuh``) and the flags, so an edited
source or header is rebuilt and a stale library is never loaded. All missing
libraries are compiled at once, one nvcc process per source, the first time
any kernel is needed; nothing is built or imported when this module is
imported (the CPU tests import every module).

Every C entry point returns ``cudaGetLastError()`` after its launch; ``check``
turns a non-zero code into an exception naming the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from .. import BUILD_DIR, PACKAGE_ROOT

CSRC = PACKAGE_ROOT / "csrc"
SOURCES = ("gemm_bf16", "attn_core", "layernorm", "layer_tail", "mha", "ln_train", "attn_train")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 900

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / "kernels" / f"{name}-{digest}.so"


def build_all() -> dict[str, str]:
    """Compile every missing library, all nvcc processes at once.

    Returns each compiled source's nvcc output (ptxas register and shared
    memory report); an already built library maps to "". Raises if any
    compile fails."""
    out_dir = BUILD_DIR / "kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        target = library_path(name)
        if target.is_file():
            continue
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    logs = {name: "" for name in SOURCES}
    failed = []
    for name, (target, tmp, proc) in procs.items():
        try:
            logs[name], _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
        else:
            tmp.unlink(missing_ok=True)
            failed.append(name)
    if failed:
        detail = "\n".join(f"--- {n}.cu ---\n{logs[n]}" for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{detail}")
    return logs


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not library_path(name).is_file():
                build_all()
            lib = ctypes.CDLL(str(library_path(name)))
            lib.kmr_error_string.argtypes = [ctypes.c_int]
            lib.kmr_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def bind(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """``symbol`` of library ``name`` with its argument types declared (every
    pointer and the stream as c_void_p, so none is cut to 32 bits)."""
    fn = _fns.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(name, symbol)] = fn
    return fn


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = load(name).kmr_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc} ({msg})")


def ptr(t, offset: int = 0) -> ctypes.c_void_p:
    """Address of element ``offset`` of tensor ``t``'s storage view."""
    return ctypes.c_void_p(t.data_ptr() + offset * t.element_size())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
