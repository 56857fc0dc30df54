"""Balanced positive/negative sampler on fixed shapes (counterpart of
``mega_pytorch_tpu/models/sampler.py``): up to ``batch * positive_fraction``
positives drawn at random, the rest of the batch filled with random
negatives. Each element draws one uniform key per class; candidates are
ranked by their key and kept below the class's budget, so shapes stay
(..., N) throughout."""

from __future__ import annotations

import torch


def _rank_among(mask: torch.Tensor, rand: torch.Tensor) -> torch.Tensor:
    """rank[i] = the position of i among the mask's elements ordered by rand."""
    key = torch.where(mask, rand, torch.full_like(rand, float("inf")))
    order = torch.argsort(key, dim=-1, stable=True)
    arange = torch.arange(order.shape[-1], device=order.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, arange)


def balanced_sample(labels: torch.Tensor, batch_size: int, positive_fraction: float,
                    generator: torch.Generator | None = None,
                    uniforms: torch.Tensor | None = None):
    """labels (..., N): -1 ignore, 0 negative, >= 1 positive → (pos_mask,
    neg_mask), (..., N) bool each. The (..., 2, N) uniforms (positive keys,
    negative keys) are drawn from ``generator`` unless given."""
    positive = labels >= 1
    negative = labels == 0
    max_pos = int(batch_size * positive_fraction)
    num_pos = positive.sum(-1, keepdim=True).clamp_max(max_pos)
    num_neg = torch.minimum(negative.sum(-1, keepdim=True), batch_size - num_pos)
    if uniforms is None:
        uniforms = torch.rand((*labels.shape[:-1], 2, labels.shape[-1]),
                              generator=generator, device=labels.device)
    pos_mask = positive & (_rank_among(positive, uniforms[..., 0, :]) < num_pos)
    neg_mask = negative & (_rank_among(negative, uniforms[..., 1, :]) < num_neg)
    return pos_mask, neg_mask
