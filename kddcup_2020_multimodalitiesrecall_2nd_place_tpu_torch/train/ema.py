"""Exponential moving average of parameters, the port of the JAX package's
``train/ema.py``.

ImageBERT-B/C's training applies EMA(0.997) to every trainable each step
(``train_normal.py:191-194``) and evaluates with the shadows. TF's
ExponentialMovingAverage updates shadow -= (1 - d) * (shadow - value) with
the effective decay d = min(decay, (1 + n) / (10 + n)) when ``num_updates``
n is passed, and the reference passes the global step
(``train_normal.py:192``), so that ramp is kept.
"""

from __future__ import annotations

import torch


class Ema:
    """Shadows of a list of parameter tensors, updated in place."""

    def __init__(self, params: list[torch.Tensor], decay: float = 0.997):
        self.shadow = [p.detach().clone() for p in params]
        self.decay = decay
        self.num_updates = 0

    def effective_decay(self) -> float:
        n = self.num_updates
        return min(self.decay, (1.0 + n) / (10.0 + n))

    @torch.no_grad()
    def update(self, params: list[torch.Tensor]) -> None:
        """shadow -= (1 - d) * (shadow - param)."""
        torch._foreach_lerp_(self.shadow, [p.detach() for p in params], 1.0 - self.effective_decay())
        self.num_updates += 1
