"""Loss primitives (counterpart of ``mega_pytorch_tpu/ops/losses.py``):
smooth-L1 and RetinaNet's sigmoid focal loss."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def smooth_l1_loss(input: torch.Tensor, target: torch.Tensor,
                   beta: float = 1.0 / 9) -> torch.Tensor:
    """Elementwise smooth-L1 with the ``beta`` knob, unreduced: the callers
    apply their own masked reductions (the JAX function's ``weights`` has
    no caller and is not ported)."""
    n = (input - target).abs()
    return torch.where(n < beta, 0.5 * n * n / beta, n - 0.5 * beta)


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, gamma: float = 2.0,
                       alpha: float = 0.25) -> torch.Tensor:
    """Per-anchor, per-class focal loss, unreduced: logits (N, C) of classes
    1..C (no background column), targets (N,) with 0 background, -1 ignore
    and c >= 1 a class → (N, C). The positive term applies on the target's
    class only, the negative term on every other class of targets >= 0;
    log(p) and log(1 - p) in their log-sigmoid forms."""
    classes = torch.arange(1, logits.shape[1] + 1, device=logits.device)[None, :]
    t = targets[:, None]
    p = torch.sigmoid(logits)
    term_pos = (1 - p) ** gamma * F.logsigmoid(logits)
    term_neg = p ** gamma * F.logsigmoid(-logits)
    pos = (t == classes).to(logits.dtype)
    neg = ((t != classes) & (t >= 0)).to(logits.dtype)
    return -pos * term_pos * alpha - neg * term_neg * (1 - alpha)
