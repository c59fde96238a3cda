"""Materialised training-instance shards, the port's copy of the JAX
package's ``data/packed.py`` (numpy only; the same format byte for byte, so a
directory written by either package loads in either).

Training instances (hard-negative pairing, curriculum sampling, MLM masking)
are drawn ONCE by draining the online sampler (``cli/build_packed.py``), then
written as one ``.npy`` per (shard, field) that memory-maps at train time
(``cli/train.py --packed-dir``): an epoch costs no re-tokenisation, re-mining
or base64 decoding, and a batch is a fancy-index gather.

* RoI features are stored float16 by default (the dominant field: 2048
  values an instance) and cast back to float32 when a batch is assembled;
* epochs are shuffled at load time by a permutation from (seed, epoch):
  shard order, then the order within each shard; a batch may span shards;
* ``process_id::process_count`` strides each shard (truncated to a multiple
  of the count first), so processes cover each instance once an epoch.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np

from ..utils.observability import span

MANIFEST = "manifest.json"


def write_packed_shards(examples: Iterable[dict], out_dir, shard_size: int = 65536, feature_dtype=np.float16,
                        max_instances: int | None = None, meta: dict | None = None) -> dict:
    """Drain an example iterator (e.g. ``HardNegativeSampler.examples``) into
    per-field ``.npy`` shards and a manifest; -> the manifest. ``meta``: more
    JSON-able key/values recorded in the manifest."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    shards: list[int] = []
    fields: dict[str, dict] = {}
    buf: list[dict] = []

    def flush():
        if not buf:
            return
        idx = len(shards)
        for key in buf[0]:
            arr = np.stack([ex[key] for ex in buf], axis=0)
            if key == "features" and feature_dtype is not None:
                arr = arr.astype(feature_dtype)
            np.save(out / f"shard_{idx:05d}.{key}.npy", arr)
            fields.setdefault(key, {"dtype": str(arr.dtype), "shape": list(arr.shape[1:])})
        shards.append(len(buf))
        buf.clear()

    for ex in examples:
        buf.append(ex)
        if len(buf) == shard_size:
            flush()
        if max_instances is not None and sum(shards) + len(buf) >= max_instances:
            break
    flush()

    manifest = {
        "version": 1,
        "num_instances": int(sum(shards)),
        "shard_sizes": shards,
        "fields": fields,
        "feature_dtype": str(np.dtype(feature_dtype)) if feature_dtype else None,
        **(meta or {}),
    }
    (out / MANIFEST).write_text(json.dumps(manifest, indent=1))
    return manifest


class PackedDataset:
    """Memory-mapped reader over a packed-shard directory."""

    def __init__(self, path):
        self.dir = Path(path)
        self.manifest = json.loads((self.dir / MANIFEST).read_text())
        self.shard_sizes = self.manifest["shard_sizes"]
        self.fields = list(self.manifest["fields"])
        # one memmap per (shard, field): nothing is read until a batch gathers it
        self._maps = [{f: np.load(self.dir / f"shard_{i:05d}.{f}.npy", mmap_mode="r") for f in self.fields}
                      for i in range(len(self.shard_sizes))]

    def __len__(self) -> int:
        return self.manifest["num_instances"]

    def _assemble(self, parts: list[tuple[dict, np.ndarray]]) -> dict:
        """One batch from its (shard, indices) parts: a gather per part, features cast to float32; span
        ``packed.gather``."""
        with span("packed.gather"):
            gathered = []
            for shard, idx in parts:
                batch = {}
                for f, arr in shard.items():
                    a = arr[idx]
                    if f == "features" and a.dtype != np.float32:
                        a = a.astype(np.float32)
                    batch[f] = a
                gathered.append(batch)
            if len(gathered) == 1:
                return gathered[0]
            return {f: np.concatenate([g[f] for g in gathered], axis=0) for f in self.fields}

    def batches(self, batch_size: int, epochs: int | None = 1, seed: int = 0, drop_remainder: bool = True,
                process_id: int = 0, process_count: int = 1, skip: int = 0) -> Iterator[dict]:
        """Shuffled batches: each epoch re-permutes the shard order and the
        order within each shard from (seed, epoch); ``epochs=None`` runs
        forever. The first ``skip`` batches are planned by index and not
        read (a resumed run's stream); the rest are exactly the batches of
        a run that skips none. Raises ``ValueError`` when an epoch holds no
        batch (``batch_size`` larger than this process's instances)."""
        epoch = planned = 0
        while epochs is None or epoch < epochs:
            n_epoch = 0
            rng = np.random.default_rng((seed, epoch))
            carry: list[tuple[dict, np.ndarray]] = []
            carry_n = 0
            for si in rng.permutation(len(self._maps)):
                shard = self._maps[si]
                order = rng.permutation(self.shard_sizes[si])
                if process_count > 1:
                    # truncated BEFORE striding, so every process yields as many instances an epoch
                    order = order[: len(order) - len(order) % process_count]
                    order = order[process_id::process_count]
                pos = 0
                while pos < len(order):
                    take = min(batch_size - carry_n, len(order) - pos)
                    carry.append((shard, order[pos:pos + take]))
                    carry_n += take
                    pos += take
                    if carry_n == batch_size:
                        n_epoch += 1
                        planned += 1
                        if planned > skip:
                            yield self._assemble(carry)
                        carry, carry_n = [], 0
            if not drop_remainder and carry:
                n_epoch += 1
                planned += 1
                if planned > skip:
                    yield self._assemble(carry)
            if n_epoch == 0:
                raise ValueError(f"batch_size={batch_size} exceeds this process's "
                                 f"{len(self) // max(process_count, 1)} packed instances")
            epoch += 1
