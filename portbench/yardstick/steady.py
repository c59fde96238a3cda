"""What keeps a window steady from the benchmark's side, none of which changes
the work the program does:

* a fixed, small pool of CPU threads for OpenMP, BLAS and torch's intra-op
  work, whatever the host's core count (``THREADS``; set before numpy or
  torch is imported);
* the data the set-up wrote flushed to disk before the window, so the
  kernel's writeback of it does not fall into the window;
* the pages of the program's memory maps touched once in set-up;
* Python's collector run, and what the set-up made frozen out of its later
  passes, before the window; unfrozen after it.
"""

from __future__ import annotations

import gc
import os
from pathlib import Path

THREADS = 4
THREAD_VARIABLES = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS", "NUMEXPR_NUM_THREADS")
PAGE = 4096


def pin_thread_env(env=os.environ) -> None:
    """The thread pools' sizes, for libraries not yet loaded."""
    for name in THREAD_VARIABLES:
        env[name] = str(THREADS)


def pin_torch_threads() -> None:
    import torch

    torch.set_num_threads(THREADS)


def flush_dir(path) -> None:
    """fsync every file under ``path``, then the directories."""
    root = Path(path)
    for p in sorted(root.rglob("*")) + [root]:
        fd = os.open(p, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)


def prefault(arrays) -> int:
    """Touch one byte of each page of each array (memory maps included); -> the bytes spanned."""
    import numpy as np

    total = 0
    for a in arrays:
        flat = np.asarray(a).reshape(-1).view(np.uint8)
        if flat.size:
            flat[::PAGE].max()
            flat[-1:].max()
        total += flat.size
    return total


def quiesce() -> None:
    gc.collect()
    gc.freeze()


def release() -> None:
    gc.unfreeze()
