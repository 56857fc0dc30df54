"""Training checkpoints with iteration resume (counterpart of
``mega_pytorch_tpu/utils/checkpoint.py``): ``torch.save`` of the model's,
optimizer's and scheduler's state and the iteration, a ``last_checkpoint``
tag file naming the newest, and ``ignore_optimizer`` (the reference's
``MODEL.VID.IGNORE``, fine-tuning from another stage's model) dropping the
optimizer and scheduler state and restarting at iteration 0.

The JAX package's ``.ckpt`` pickles are not read: their optax state does not
unpickle without JAX. Its weights reach the port through ``utils/bridge.py``
and reference ``.pth`` files through ``utils/model_ingest.py``.
"""

from __future__ import annotations

import os

import torch


class Checkpointer:
    def __init__(self, save_dir: str, logger=None):
        self.save_dir = save_dir
        self.logger = logger
        os.makedirs(save_dir, exist_ok=True)

    def _tag_file(self) -> str:
        return os.path.join(self.save_dir, "last_checkpoint")

    def save(self, name: str, model, optimizer=None, scheduler=None,
             iteration: int = 0) -> str:
        path = os.path.join(self.save_dir, f"{name}.pth")
        torch.save({
            "model": model.state_dict(),
            "optimizer": None if optimizer is None else optimizer.state_dict(),
            "scheduler": None if scheduler is None else scheduler.state_dict(),
            "iteration": iteration,
        }, path)
        with open(self._tag_file(), "w") as f:
            f.write(path)
        if self.logger:
            self.logger.info(f"Saved checkpoint to {path}")
        return path

    def has_checkpoint(self) -> bool:
        return os.path.exists(self._tag_file())

    def last_checkpoint(self) -> str | None:
        if not self.has_checkpoint():
            return None
        with open(self._tag_file()) as f:
            return f.read().strip()

    def load(self, path: str | None = None, ignore_optimizer: bool = False,
             map_location="cpu") -> dict:
        """The payload of ``path``, or of the tagged last checkpoint ({} if
        there is none)."""
        path = path or self.last_checkpoint()
        if not path or not os.path.exists(path):
            return {}
        payload = torch.load(path, map_location=map_location, weights_only=True)
        if ignore_optimizer:
            payload.update(optimizer=None, scheduler=None, iteration=0)
        if self.logger:
            self.logger.info(f"Loaded checkpoint from {path}")
        return payload

    @staticmethod
    def restore(payload: dict, model, optimizer=None, scheduler=None) -> int:
        """Load a payload's states into the objects given (the optimizer and
        scheduler only where it holds theirs); returns its iteration."""
        model.load_state_dict(payload["model"])
        if optimizer is not None and payload.get("optimizer") is not None:
            optimizer.load_state_dict(payload["optimizer"])
        if scheduler is not None and payload.get("scheduler") is not None:
            scheduler.load_state_dict(payload["scheduler"])
        return int(payload.get("iteration", 0))
