"""Logging on stdlib ``logging`` and smoothed training meters (counterpart of
``mega_pytorch_tpu/utils/logger.py``): stdout plus ``log.txt`` in the
output directory; window-20 median and global average of each meter."""

from __future__ import annotations

import logging
import os
import statistics
import sys
from collections import defaultdict, deque


def setup_logger(name: str, save_dir: str | None) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    ch = logging.StreamHandler(stream=sys.stdout)
    ch.setFormatter(fmt)
    logger.addHandler(ch)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(save_dir, "log.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class SmoothedValue:
    """A window of values with its median and the global average."""

    def __init__(self, window_size: int = 20):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float) -> None:
        self.deque.append(value)
        self.count += 1
        self.total += value

    @property
    def median(self) -> float:
        return statistics.median(self.deque)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class MetricLogger:
    def __init__(self):
        self.meters: dict = defaultdict(SmoothedValue)

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self) -> str:
        return "  ".join(f"{name}: {m.median:.4f} ({m.global_avg:.4f})"
                         for name, m in self.meters.items())
