"""Loss primitives (counterpart of ``mega_pytorch_tpu/ops/losses.py``,
``smooth_l1_loss``; the focal loss is RetinaNet's and belongs to the zoo)."""

from __future__ import annotations

import torch


def smooth_l1_loss(input: torch.Tensor, target: torch.Tensor,
                   beta: float = 1.0 / 9) -> torch.Tensor:
    """Elementwise smooth-L1 with the ``beta`` knob, unreduced: the callers
    apply their own masked reductions (the JAX function's ``weights`` has
    no caller and is not ported)."""
    n = (input - target).abs()
    return torch.where(n < beta, 0.5 * n * n / beta, n - 0.5 * beta)
