"""The build cache of the port's kernels, the counterpart of the JAX
package's persistent compile cache (``utils/cache.py``).

The JAX package points XLA at an on-disk compilation cache before its first
trace. The port's only compiled artifacts are its CUDA kernels: each
``csrc/*.cu`` is built by nvcc into ``build/kernels/`` once, under a hash of
its sources and flags, and reused by every later process
(``ops/_build.py``). ``enable_persistent_compile_cache`` builds, or loads
from that cache, every kernel library now, so that no timed call of a
measuring CLI pays a build; it adds no setting of its own.
"""

from __future__ import annotations


def enable_persistent_compile_cache(min_compile_secs: float = 0.5) -> None:
    """Build or load every kernel library of ``ops/_build.py`` (``build/kernels/``)
    when a CUDA device is present; on the CPU the wrappers run their plain
    versions, so there is nothing to build. ``min_compile_secs`` is the JAX
    signature's, unused: every kernel is cached."""
    del min_compile_secs
    import torch

    if not torch.cuda.is_available():
        return
    from ..ops import _build

    _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
