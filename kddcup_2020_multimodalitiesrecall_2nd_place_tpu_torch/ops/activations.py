"""Activations with the exact variants the reference checkpoints were trained on.

* ImageBERT-A/B/C use the tanh-approximated GELU (``pixelmodel.py:307-320``):
  0.5*x*(1+tanh(sqrt(2/pi)*(x+0.044715*x^3))).
* LXMERT uses the erf GELU (``lxmert/src/lxrt/modeling.py`` ACT2FN['gelu']).

Mixing them up costs ~1e-3 per-activation drift, the whole parity budget.
"""

import torch
import torch.nn.functional as F


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")

