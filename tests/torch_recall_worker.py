"""One gloo rank of ``tests/test_torch_recall_sharded.py``: ``recall_sharded`` of every case in an npz.

    python tests/torch_recall_worker.py <rank> <world> <port> <cases.npz> <out.npz>

The npz holds ``<case>/q``, ``<case>/catalog``, ``<case>/k`` and ``<case>/chunk``; rank 0 writes
``<case>/scores`` and ``<case>/indices``.
"""

import os
import sys

import numpy as np


def main() -> None:
    rank, world, port, cases, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch
    import torch.distributed as dist

    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models.two_tower import recall_sharded
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.parallel import make_mesh, maybe_initialize

    torch.set_num_threads(1)
    assert maybe_initialize(f"tcp://localhost:{port}", world, rank, device="cpu")
    mesh = make_mesh()
    results = {}
    with np.load(cases) as f:
        names = sorted({k.split("/")[0] for k in f.files})
        for name in names:
            s, i = recall_sharded(torch.from_numpy(f[f"{name}/q"]), torch.from_numpy(f[f"{name}/catalog"]), mesh,
                                  k=int(f[f"{name}/k"]), chunk=int(f[f"{name}/chunk"]))
            results[f"{name}/scores"], results[f"{name}/indices"] = s.numpy(), i.numpy()
    if rank == 0:
        np.savez(out, **results)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
