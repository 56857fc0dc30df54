from .build import make_lr_scheduler, make_optimizer, param_labels, warmup_multistep_factor

__all__ = ["make_lr_scheduler", "make_optimizer", "param_labels", "warmup_multistep_factor"]
