"""Optimizer and learning-rate schedule (counterpart of
``mega_pytorch_tpu/solver/build.py``).

SGD with momentum 0.9 in the reference's update order: weight decay folded
into the gradient, then the momentum trace, then the step (``optax``'s
``add_decayed_weights`` → ``trace``, which ``torch.optim.SGD`` computes).
Parameters fall in two groups by the JAX package's rule: a parameter named
exactly ``bias`` takes ``BIAS_LR_FACTOR`` and ``WEIGHT_DECAY_BIAS``; every
other one (``Wv_bias`` and ``u`` included) is a weight. Frozen parameters
(``requires_grad`` False: the stages below ``FREEZE_CONV_BODY_AT``) are left
out; FrozenBN statistics are buffers. The warmup-multistep schedule is a
``LambdaLR`` stepped after each ``optimizer.step()``, so iteration 0 runs at
``WARMUP_FACTOR`` (optax's count is 0 at the first update).
"""

from __future__ import annotations

import bisect

import torch


def param_labels(model: torch.nn.Module) -> dict[str, str]:
    """{parameter name: "frozen" | "bias" | "weight"}."""
    return {
        name: ("frozen" if not p.requires_grad
               else "bias" if name.rsplit(".", 1)[-1] == "bias" else "weight")
        for name, p in model.named_parameters()
    }


def warmup_multistep_factor(steps, gamma: float = 0.1, warmup_factor: float = 1.0 / 3,
                            warmup_iters: int = 500, warmup_method: str = "linear"):
    """it → lr(it) / base_lr: the warmup factor below ``warmup_iters``
    (linear from ``warmup_factor`` to 1, or constant), times gamma to the
    number of milestones in ``steps`` that ``it`` has reached."""
    if warmup_method not in ("constant", "linear"):
        raise ValueError(f"unknown warmup method {warmup_method!r}")
    milestones = sorted(steps)

    def factor(it: int) -> float:
        warm = 1.0
        if it < warmup_iters:
            if warmup_method == "constant":
                warm = warmup_factor
            else:
                alpha = it / max(warmup_iters, 1)
                warm = warmup_factor * (1.0 - alpha) + alpha
        return warm * gamma ** bisect.bisect_right(milestones, it)

    return factor


def make_optimizer(cfg, model: torch.nn.Module) -> torch.optim.SGD:
    """SGD over the model's trainable parameters in the weight and bias
    groups (each group's "name" says which)."""
    s = cfg.SOLVER
    labels = param_labels(model)
    params = dict(model.named_parameters())
    groups = []
    for name, lr, decay in (("weight", s.BASE_LR, s.WEIGHT_DECAY),
                            ("bias", s.BASE_LR * s.BIAS_LR_FACTOR, s.WEIGHT_DECAY_BIAS)):
        members = [params[n] for n, label in labels.items() if label == name]
        if members:
            groups.append(dict(params=members, lr=lr, weight_decay=decay, name=name))
    return torch.optim.SGD(groups, lr=s.BASE_LR, momentum=s.MOMENTUM)


def make_lr_scheduler(cfg, optimizer: torch.optim.Optimizer) -> torch.optim.lr_scheduler.LambdaLR:
    s = cfg.SOLVER
    return torch.optim.lr_scheduler.LambdaLR(optimizer, warmup_multistep_factor(
        s.STEPS, s.GAMMA, s.WARMUP_FACTOR, s.WARMUP_ITERS, s.WARMUP_METHOD))
