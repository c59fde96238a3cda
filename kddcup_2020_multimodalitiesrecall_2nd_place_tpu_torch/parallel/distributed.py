"""Multi-process data parallelism on ``torch.distributed``, the port of the
JAX package's ``parallel/distributed.py``.

* ``maybe_initialize``: the process group from ``torchrun``'s environment
  (``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``) or explicit
  arguments; ``force=True`` (``cli/train.py --distributed``) or
  ``KMR_DISTRIBUTED=1`` requires them. NCCL on ``cuda``, gloo on ``cpu``
  (NCCL takes one rank a device, so several ranks on the one card of a
  machine use gloo, asked for by name).
* ``process_shard``, ``stride_lines``, ``local_rows``: the JAX helpers, with
  the group's rank and world size for JAX's process index and count.
* ``global_batch_from_local``: a rank's host rows are its share of the
  logical global batch (the concatenation in rank order); there is no
  global array to assemble, so the rows pass as they are.
* ``all_gather_rows`` (autograd, for the losses that couple rows),
  ``all_reduce_sum``, ``all_reduce_mean_``, ``broadcast_``: the collectives
  the trainer and ``recall_sharded`` use, identities without a group.
"""

from __future__ import annotations

import itertools
import os
import warnings
from typing import Sequence

import torch

from .mesh import Mesh

TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if initialized() else 0


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if initialized() else 1


_world_size = process_count  # for the helpers whose process_count argument shadows it


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def maybe_initialize(init_method: str | None = None, world_size: int | None = None, rank: int | None = None,
                     force: bool = False, device="cuda", backend: str | None = None) -> bool:
    """Initialise the process group when configured; -> True if a group is up.

    Explicit ``init_method`` (``tcp://host:port``) with ``world_size`` and
    ``rank`` win; otherwise ``torchrun``'s environment (``env://``). With
    ``force`` or ``KMR_DISTRIBUTED=1`` and neither, it raises: there is no
    cluster to detect. ``backend`` defaults to NCCL on ``cuda``, gloo on
    ``cpu``; a ``cuda`` rank's current device is ``LOCAL_RANK``'s."""
    import torch.distributed as dist

    if initialized():
        return True
    env_ready = all(k in os.environ for k in TORCHRUN_ENV)
    if init_method is None and not env_ready:
        if force or os.environ.get("KMR_DISTRIBUTED") == "1":
            missing = [k for k in TORCHRUN_ENV if k not in os.environ]
            raise RuntimeError(f"distributed training asked for, but {missing} are not set: start it with "
                               "torchrun or pass init_method, world_size and rank")
        return False
    backend = backend or default_backend(device)
    if torch.device(device).type == "cuda" and backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if init_method is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return True


def process_shard(paths: Sequence, process_id: int | None = None,
                  process_count: int | None = None) -> tuple[list, bool]:
    """This process's slice of the input files, and whether line striding is
    needed: files dealt round-robin when there is at least one a process,
    else every process reads every file and keeps lines ``pid::n``
    (``stride_lines``)."""
    pid = process_index() if process_id is None else process_id
    n = _world_size() if process_count is None else process_count
    if len(paths) >= n:
        return [p for i, p in enumerate(paths) if i % n == pid], False
    return list(paths), True


def stride_lines(lines, process_id: int | None = None, process_count: int | None = None):
    """Disjoint line-level round-robin over a shared line stream."""
    pid = process_index() if process_id is None else process_id
    n = _world_size() if process_count is None else process_count
    return itertools.islice(lines, pid, None, n)


def local_rows(global_batch_size: int, process_id: int | None = None, process_count: int | None = None) -> int:
    """Rows this process contributes to one global batch."""
    n = _world_size() if process_count is None else process_count
    assert global_batch_size % n == 0, (global_batch_size, n)
    return global_batch_size // n


def global_batch_from_local(mesh: Mesh, local_batch: dict) -> dict:
    """This rank's rows of the global batch, as they are: the global batch is
    the ranks' rows in rank order (one process: the batch itself)."""
    del mesh
    return local_batch


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The ranks' ``x`` [n, ...] concatenated in rank order -> [world * n, ...],
    differentiable (``torch.distributed.nn.functional.all_gather``: the
    gradient of each rank's rows is the sum over ranks); ``x`` without a group."""
    if process_count() == 1:
        return x
    import torch.distributed.nn.functional as dist_nn

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)  # its deprecation notice, once a call
        return torch.cat(dist_nn.all_gather(x.contiguous()), dim=0)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of ``x`` (a new tensor, no gradient)."""
    if process_count() == 1:
        return x
    import torch.distributed as dist

    out = x.detach().clone()
    dist.all_reduce(out)
    return out


def all_reduce_mean_(tensors: list[torch.Tensor]) -> None:
    """Each tensor replaced, in place, by its mean over ranks: one all-reduce
    of their concatenation, then the division by the world size."""
    if not initialized() or not tensors:
        return
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat /= process_count()
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors]), strict=True):
        t.copy_(part.view_as(t))


def broadcast_(tensors: list[torch.Tensor], src: int = 0) -> None:
    """Each tensor overwritten, in place, by rank ``src``'s."""
    if not initialized() or not tensors:
        return
    import torch.distributed as dist

    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.broadcast(flat, src)
    with torch.no_grad():
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors]), strict=True):
            t.copy_(part.view_as(t))
