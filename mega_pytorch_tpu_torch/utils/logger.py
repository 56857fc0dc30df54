"""Logging on stdlib ``logging`` (counterpart of ``setup_logger`` in
``mega_pytorch_tpu/utils/logger.py``): stdout plus ``log.txt`` in the
output directory."""

from __future__ import annotations

import logging
import os
import sys


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
