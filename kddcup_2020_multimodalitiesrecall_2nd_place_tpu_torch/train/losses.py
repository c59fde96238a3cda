"""Training losses beside the heads' own: Multi-Similarity.

``ms_loss`` follows ``imagebert_lds/src/msloss.py:6-50`` (CVPR'19
Multi-Similarity, alpha=2, beta=50, lambda=1), the ``--ms-weight`` term of
ImageBERT-A's ModelCheckPointGPUSATTLOSS fine-tune, as the JAX package's
``train/losses.py`` :16-49 computes it (f32 throughout).
"""

from __future__ import annotations

import torch


def ms_loss(labels: torch.Tensor, embeddings: torch.Tensor, alpha: float = 2.0, beta: float = 50.0,
            lamb: float = 1.0, eps: float = 0.1, ms_mining: bool = False) -> torch.Tensor:
    """labels [B] int, embeddings [B, D] -> the mean MS loss over anchors."""
    x = embeddings.float()
    x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1e-12)
    batch = x.shape[0]
    labels = labels.reshape(-1, 1)
    adjacency = labels == labels.T
    mask_pos = adjacency.float() - torch.eye(batch, device=x.device)
    mask_neg = (~adjacency).float()
    sim = torch.clamp(x @ x.T, min=0.0)
    pos_mat = sim * mask_pos
    neg_mat = sim * mask_neg
    if ms_mining:
        max_val = neg_mat.max(dim=1, keepdim=True).values
        tmp_max = pos_mat.max(dim=1, keepdim=True).values
        min_val = ((sim - tmp_max) * mask_pos).min(dim=1, keepdim=True).values + tmp_max
        mask_pos = torch.where(pos_mat < max_val + eps, mask_pos, 0.0)
        mask_neg = torch.where(neg_mat > min_val - eps, mask_neg, 0.0)
    pos_exp = torch.where(mask_pos > 0.0, torch.exp(-alpha * (pos_mat - lamb)), 0.0)
    neg_exp = torch.where(mask_neg > 0.0, torch.exp(beta * (neg_mat - lamb)), 0.0)
    pos_term = torch.log1p(pos_exp.sum(dim=1)) / alpha
    neg_term = torch.log1p(neg_exp.sum(dim=1)) / beta
    return (pos_term + neg_term).mean()
