"""ImageBERT-B's first training steps in plain PyTorch, float32: the loss of
``models.imagebert_b_loss``, its gradient by autograd, the value clip, Adam
with bias correction (b1 0.9, b2 0.999, eps 1e-8) at ``lr * 0.94 ** (step //
2500)``, and the exponential moving average whose decay ramps as
``min(decay, (1 + n) / (10 + n))`` (TF's ``ExponentialMovingAverage`` with the
step passed), from ``zk train_normal.py``."""

from __future__ import annotations

import torch

from .models import imagebert_b_loss

BETA_1, BETA_2, EPSILON = 0.9, 0.999, 1e-8


def _flat(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _tree(flat: dict[str, torch.Tensor]) -> dict:
    out: dict = {}
    for name, t in flat.items():
        node = out
        *path, leaf = name.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t
    return out


def train_steps(params: dict, batches: list[dict], step_seeds: list[int], cfg: dict, recipe: dict,
                lowp: bool = False) -> dict:
    """-> {"losses": [float], "probs": the first step's rows' probability of class 1,
    "grads": {name: the first step's clipped gradient},
    "grad_max_abs": [each step's largest |gradient| before the clip], "clipped_max_abs": [the same after it],
    "stairs": [each step's stair of the learning rate's staircase],
    "params": {name: after the steps}, "ema": {name: the shadows after the steps}, "start": {name: before}}."""
    start = {k: v.detach().clone() for k, v in _flat(params).items()}
    leaves = {k: v.clone().requires_grad_() for k, v in start.items()}
    m = {k: torch.zeros_like(v) for k, v in start.items()}
    v2 = {k: torch.zeros_like(v) for k, v in start.items()}
    ema = {k: v.clone() for k, v in start.items()}
    losses, first, probs, peaks, clipped_peaks, stairs = [], None, None, [], [], []
    for step, (batch, seed) in enumerate(zip(batches, step_seeds, strict=True)):
        loss, row_probs = imagebert_b_loss(_tree(leaves), batch, cfg, seed, lowp)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        losses.append(float(loss.detach()))
        peaks.append(float(torch.stack([g.detach().abs().max() for g in grads if g is not None]).max()))
        stairs.append(step // 2500)
        t = step + 1
        lr = recipe["learning_rate"] * 0.94 ** stairs[-1]
        decay = min(recipe["ema_decay"], (1.0 + step) / (10.0 + step))
        with torch.no_grad():
            clipped = {}
            for (name, p), g in zip(leaves.items(), grads):
                g = torch.zeros_like(p) if g is None else g.clamp(-recipe["clip_value"], recipe["clip_value"])
                clipped[name] = g
                m[name] = BETA_1 * m[name] + (1.0 - BETA_1) * g
                v2[name] = BETA_2 * v2[name] + (1.0 - BETA_2) * g * g
                p -= lr * (m[name] / (1.0 - BETA_1 ** t)) / (torch.sqrt(v2[name] / (1.0 - BETA_2 ** t)) + EPSILON)
                ema[name] -= (1.0 - decay) * (ema[name] - p)
        clipped_peaks.append(float(torch.stack([g.abs().max() for g in clipped.values()]).max()))
        if first is None:
            first, probs = clipped, row_probs.detach()
    return {"losses": losses, "probs": probs, "grads": first, "grad_max_abs": peaks, "clipped_max_abs": clipped_peaks,
            "stairs": stairs, "params": {k: v.detach() for k, v in leaves.items()},
            "ema": ema, "start": start}
