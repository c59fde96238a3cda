"""Optimizers, LR schedules and clipping of the reference training setups,
the port of the JAX package's ``train/optim.py``, as plain torch ``foreach``
ops over the parameter tree (no optimizer library).

* ``BertAdamW``: Google-BERT's AdamWeightDecayOptimizer
  (``imagebert_lds/src/optimization.py:128-213``): Adam **without bias
  correction**, decoupled weight decay added to the update *before* the LR
  multiply, decay excluded for any parameter whose path holds LayerNorm,
  layer_norm or bias (``decay_mask``). The port's fused ``qkv/bias`` is
  excluded and ``qkv/kernel`` decayed, as their query/key/value parts are in
  the JAX tree.
* ``Adam``: ``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) with
  bias correction, ImageBERT-B/C's optimizer (zk ``train_normal.py:133-137``;
  the JAX package's ``train/trainer.py`` :118-120).
* ``polynomial_warmup_schedule``: linear warmup, then linear decay to 0
  (``optimization.py:25-67``).
* ``exponential_staircase_schedule``: 0.94 every 2500 steps, staircase
  (zk ``train_normal.py:133-137``).
* ``clip_by_global_norm`` (``run_pretraining_predict_score.py:234-286``, 1.0)
  and ``clip_by_value`` (``train_normal.py:93``, +-1), in place.
* ``grad_group_norms``: the per-group gradient norms of the reference's
  ``clip_by_global_norm_summary`` (``:234-258``), as the JAX package groups them.
"""

from __future__ import annotations

from typing import Callable

import torch

DECAY_EXCLUDE_SUBSTRINGS = ("LayerNorm", "layer_norm", "bias")
# AdamWeightDecayOptimizer's settings in the reference (optimization.py:59-65)
WEIGHT_DECAY_RATE, BETA_1, BETA_2, EPSILON = 0.01, 0.9, 0.999, 1e-6
# optax.adam's defaults, ImageBERT-B/C's tf.train.AdamOptimizer
ADAM_EPSILON = 1e-8


def flatten_paths(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """{"a/b/c": leaf} of a nested dict, in its insertion order."""
    out: dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_paths(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def decay_mask(params: dict) -> dict[str, bool]:
    """path -> True where weight decay applies (TF re.search semantics: a
    substring test, so ``output_bias`` and slim's ``biases`` are excluded too)."""
    return {name: not any(s in name for s in DECAY_EXCLUDE_SUBSTRINGS) for name in flatten_paths(params)}


def polynomial_warmup_schedule(init_lr: float, num_train_steps: int,
                               num_warmup_steps: int) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        decayed = init_lr * (1.0 - min(step / num_train_steps, 1.0))
        if num_warmup_steps and step < num_warmup_steps:
            return init_lr * step / num_warmup_steps
        return decayed

    return schedule


def exponential_staircase_schedule(init_lr: float, decay_steps: int = 2500,
                                   decay_rate: float = 0.94) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        return init_lr * decay_rate ** (step // decay_steps)

    return schedule


class BertAdamW:
    """BERT Adam over the leaves of a parameter tree: m = b1 m + (1 - b1) g,
    v = b2 v + (1 - b2) g^2, update = m / (sqrt(v) + eps) (+ wd * p where
    decayed), p -= lr(step) * update. ``step`` counts the updates made."""

    def __init__(self, params: dict, learning_rate: Callable[[int], float]):
        named = flatten_paths(params)
        mask = decay_mask(params)
        self.names = list(named)
        self.lr = learning_rate
        self.m = [torch.zeros_like(p) for p in named.values()]
        self.v = [torch.zeros_like(p) for p in named.values()]
        self.decayed = [i for i, n in enumerate(self.names) if mask[n]]
        self.step = 0

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor]) -> float:
        """One step on ``params`` (the leaves in ``names`` order) in place; -> the LR used."""
        lr = self.lr(self.step)
        torch._foreach_mul_(self.m, BETA_1)
        torch._foreach_add_(self.m, grads, alpha=1.0 - BETA_1)
        torch._foreach_mul_(self.v, BETA_2)
        torch._foreach_addcmul_(self.v, grads, grads, value=1.0 - BETA_2)
        denom = torch._foreach_sqrt(self.v)
        torch._foreach_add_(denom, EPSILON)
        upd = torch._foreach_div(self.m, denom)
        torch._foreach_add_([upd[i] for i in self.decayed], [params[i] for i in self.decayed], alpha=WEIGHT_DECAY_RATE)
        torch._foreach_add_(params, upd, alpha=-lr)
        self.step += 1
        return lr


class Adam:
    """Adam with bias correction over the leaves of a parameter tree, as
    ``optax.adam``: m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, after t
    updates p -= lr(t - 1) * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps).
    The schedule reads the count before its increment, as optax's
    ``scale_by_schedule`` does. ``names`` and ``step`` as ``BertAdamW``'s."""

    def __init__(self, params: dict, learning_rate: Callable[[int], float]):
        named = flatten_paths(params)
        self.names = list(named)
        self.lr = learning_rate
        self.m = [torch.zeros_like(p) for p in named.values()]
        self.v = [torch.zeros_like(p) for p in named.values()]
        self.step = 0

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor]) -> float:
        """One step on ``params`` (the leaves in ``names`` order) in place; -> the LR used."""
        lr = self.lr(self.step)
        t = self.step + 1
        torch._foreach_mul_(self.m, BETA_1)
        torch._foreach_add_(self.m, grads, alpha=1.0 - BETA_1)
        torch._foreach_mul_(self.v, BETA_2)
        torch._foreach_addcmul_(self.v, grads, grads, value=1.0 - BETA_2)
        denom = torch._foreach_div(self.v, 1.0 - BETA_2**t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPSILON)
        upd = torch._foreach_div(self.m, 1.0 - BETA_1**t)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(params, upd, alpha=-lr)
        self.step = t
        return lr


Optimizer = BertAdamW | Adam


@torch.no_grad()
def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float = 1.0) -> torch.Tensor:
    """Scale ``grads`` in place to a global L2 norm of at most ``max_norm``;
    -> the norm before clipping (a 0-d tensor, no host sync)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    torch._foreach_mul_(grads, scale)
    return norm


@torch.no_grad()
def clip_by_value(grads: list[torch.Tensor], clip: float = 1.0) -> None:
    for g in grads:
        g.clamp_(-clip, clip)


@torch.no_grad()
def grad_group_norms(names: list[str], grads: list[torch.Tensor]) -> dict[str, torch.Tensor]:
    """L2 norm of the gradients of each group of leaves, the group being the
    first two components of a leaf's path (``bert/embeddings``,
    ``bert/encoder``, ``cls/seq_relationship``; a one-component path is its
    own group), as the JAX package's ``train/optim.py`` :134-152 groups its
    tree. The port's fused forms (``qkv``, LXMERT's ``query``/``kv``) lie below
    the second component, so the groups carry the JAX tree's names. Summed in
    f32 on the gradients' device; -> group -> 0-d tensor (no host sync)."""
    groups: dict[str, list[torch.Tensor]] = {}
    for name, g in zip(names, grads, strict=True):
        groups.setdefault("/".join(name.split("/")[:2]), []).append(g.float())
    return {group: torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs))) for group, gs in groups.items()}
