"""Activations with the exact variants the reference checkpoints were trained on.

* ImageBERT-A/B/C use the tanh-approximated GELU (``pixelmodel.py:307-320``):
  0.5*x*(1+tanh(sqrt(2/pi)*(x+0.044715*x^3))).
* LXMERT uses the erf GELU (``lxmert/src/lxrt/modeling.py`` ACT2FN['gelu']).
* ``gelu_bwd``: d gelu / du of either, the training backward's derivative
  (the JAX package's ``ops/pallas_train.py`` :64-72).

Mixing them up costs ~1e-3 per-activation drift, the whole parity budget.
"""

import math

import torch
import torch.nn.functional as F

_GELU_C = math.sqrt(2.0 / math.pi)
_GELU_A = 0.044715


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def gelu_bwd(u: torch.Tensor, approximate: bool) -> torch.Tensor:
    """d gelu / du in float32."""
    u = u.float()
    if approximate:
        t = torch.tanh(_GELU_C * (u + _GELU_A * u * u * u))
        return 0.5 * (1.0 + t) + 0.5 * u * (1.0 - t * t) * _GELU_C * (1.0 + 3.0 * _GELU_A * u * u)
    phi = torch.exp(-0.5 * u * u) / math.sqrt(2.0 * math.pi)
    return 0.5 * (1.0 + torch.erf(u * 2.0**-0.5)) + u * phi
