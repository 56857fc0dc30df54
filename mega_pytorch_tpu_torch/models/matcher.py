"""IoU matcher with padded ground truth (counterpart of
``mega_pytorch_tpu/models/matcher.py``): each prediction gets the index of
its best ground truth, demoted to BELOW_LOW (-1) or BETWEEN (-2) by the
thresholds; with ``allow_low_quality_matches`` every prediction that ties a
ground truth's best IoU keeps its match. Padded ground truths never match,
and ties take the first index, as ``jnp.argmax`` does."""

from __future__ import annotations

import torch

BELOW_LOW_THRESHOLD = -1
BETWEEN_THRESHOLDS = -2


def match(iou: torch.Tensor, gt_valid: torch.Tensor, high_threshold: float,
          low_threshold: float, allow_low_quality_matches: bool = False) -> torch.Tensor:
    """iou (..., M, N): M padded ground truths by N predictions; gt_valid
    (..., M) bool → (..., N) int64: a ground-truth index, -1 or -2."""
    quality = torch.where(gt_valid[..., :, None], iou, torch.full_like(iou, -1.0))
    matched_vals, all_matches = quality.max(dim=-2)  # the first maximum on ties
    matches = torch.where(
        matched_vals < low_threshold, torch.full_like(all_matches, BELOW_LOW_THRESHOLD),
        torch.where(matched_vals < high_threshold,
                    torch.full_like(all_matches, BETWEEN_THRESHOLDS), all_matches))
    if allow_low_quality_matches:
        best_per_gt = quality.max(dim=-1, keepdim=True).values  # (..., M, 1)
        is_best = (quality == best_per_gt) & gt_valid[..., :, None] & (best_per_gt > -1.0)
        matches = torch.where(is_best.any(dim=-2), all_matches, matches)
    return matches
