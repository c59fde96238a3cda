"""The data-parallel layout over the process group, the port of the JAX
package's ``parallel/mesh.py``.

The JAX package builds a ``jax.sharding.Mesh`` with a ``data`` axis (the
pair batch split across chips) and a ``model`` axis reserved for tensor
parallelism, and lets XLA insert the collectives. The port runs one process
a rank (``torch.distributed``) and moves the rows itself: ``Mesh`` is the
group's layout, ``shard_batch`` a global host batch's rows of this rank,
and the trainer all-reduces the gradients (``train/trainer.py``). Every
rank is on the ``data`` axis: the ``model`` axis is reserved, as in the JAX
package, and a mesh with more than one rank on it is refused, since no
tensor-parallel layer exists in either package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """``n_data`` ranks on the data axis; this process is data index ``rank``."""

    n_data: int
    rank: int
    n_model: int = 1

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}


def make_mesh(n_data: int | None = None, n_model: int = 1) -> Mesh:
    """The mesh over the process group (a one-rank mesh when none is
    initialised); ``n_data`` defaults to the world size."""
    from .distributed import process_count, process_index

    if n_model != 1:
        raise ValueError("the model axis is reserved (no tensor-parallel layer exists); n_model must be 1")
    world = process_count()
    n_data = world if n_data is None else n_data
    if n_data != world:
        raise ValueError(f"a data axis of {n_data} ranks over a process group of {world}")
    return Mesh(n_data, process_index())


def batch_sharding(mesh: Mesh, rows: int) -> slice:
    """This rank's rows of a global batch of ``rows``: the leading batch dim
    split evenly over the data axis, in rank order."""
    if rows % mesh.n_data:
        raise ValueError(f"a batch of {rows} rows does not split over {mesh.n_data} ranks")
    per = rows // mesh.n_data
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def replicated(mesh: Mesh) -> slice:
    """Every row, on every rank."""
    del mesh
    return slice(None)


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """A global host batch -> this rank's rows of every entry."""
    rows = len(next(iter(batch.values())))
    sl = batch_sharding(mesh, rows)
    return {k: np.asarray(v)[sl] for k, v in batch.items()}


def data_parallel_batch_size(mesh: Mesh, per_device: int) -> int:
    return per_device * mesh.shape[DATA_AXIS]
