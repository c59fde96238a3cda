"""PyTorch ``.pth`` state-dict reading, the port of the JAX package's
``checkpoint/torch_io.py``.

Covers the LXMERT ``BEST.pth`` checkpoint (``tasks/kdd_model.py:131-152``):
``torch.load(map_location="cpu", weights_only=True)``, a module unwrapped to
its ``state_dict()``, then every tensor as a numpy array. DataParallel
``module.`` prefixes and the gamma/beta renames are left to
``importers.normalize_torch_keys``.
"""

from __future__ import annotations

import numpy as np
import torch


def read_torch_state_dict(path) -> dict[str, np.ndarray]:
    state = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    out = {}
    for k, v in state.items():
        if hasattr(v, "numpy"):
            out[k] = v.detach().cpu().numpy()
        else:
            out[k] = np.asarray(v)
    return out
