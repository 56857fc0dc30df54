"""Training entry point (counterpart of the repo's ``tools/train_net.py``).

    python -m mega_pytorch_tpu_torch.tools.train_net --preset mega_R_101 \\
        --data-dir datasets [--config-file F ...] [--resume] [opts KEY VALUE ...]

Builds the detector for training from the preset (``--config-file`` stacks
merged in order, then the opts), weights drawn from ``--seed`` and, where
``MODEL.WEIGHT`` names a file, a mega.pytorch ``.pth`` loaded over them;
concatenates the ``DATASETS.TRAIN`` sets (train side, orientation groups),
and runs ``do_train`` with SGD and the warmup-multistep schedule,
checkpointing into ``--output-dir`` (``--resume`` continues from its
``last_checkpoint``). Only the base and MEGA methods train. The run takes
the CUDA card unless ``--device cpu`` is given, and fails where there is
none.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="video detection training on the card")
    parser.add_argument("--preset", default="base_R_50")
    parser.add_argument("--config-file", action="append", default=None)
    parser.add_argument("--data-dir", default="datasets")
    parser.add_argument("--output-dir", default="output")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; nothing falls back to the CPU")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the initial weights and the samplers' draws")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return parser.parse_args(argv)


class Concat:
    """Datasets one after the other (the reference's train tuple)."""

    def __init__(self, datasets):
        self.ds = datasets
        self.cum = np.cumsum([len(d) for d in datasets])

    def __len__(self):
        return int(self.cum[-1])

    def _locate(self, i):
        k = int(np.searchsorted(self.cum, i, side="right"))
        return self.ds[k], i - (int(self.cum[k - 1]) if k else 0)

    def __getitem__(self, i):
        ds, j = self._locate(i)
        return ds[j]

    def get_img_info(self, i):
        ds, j = self._locate(i)
        return ds.get_img_info(j)


def orientation_groups(dataset) -> list[int]:
    """1 for a portrait image, 0 otherwise: batches never mix the two."""
    infos = (dataset.get_img_info(i) for i in range(len(dataset)))
    return [int(info["height"] > info["width"]) for info in infos]


def main(argv=None) -> dict:
    """Runs the training; returns ``do_train``'s record."""
    from ..data.loader import TrainPreprocessor, train_batches
    from ..data.paths_catalog import build_dataset
    from ..data.samplers import training_indices
    from ..engine.trainer import do_train
    from ..models.detectors import build_training_model
    from ..solver import make_lr_scheduler, make_optimizer
    from ..utils.checkpoint import Checkpointer
    from ..utils.logger import setup_logger
    from ..utils.model_ingest import load_reference_weights
    from .test_net import load_config

    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_net: no CUDA card here; --device cpu runs on the CPU")
    cfg = load_config(args)
    method = cfg.MODEL.VID.METHOD if cfg.MODEL.VID.ENABLE else "base"
    if method not in ("base", "mega"):
        raise NotImplementedError(f"training of {method!r} is not ported")
    os.makedirs(args.output_dir, exist_ok=True)
    logger = setup_logger("mega_pytorch_tpu_torch.train", args.output_dir)
    logger.info(f"{args.preset} ({method}) on {device}"
                + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    with open(os.path.join(args.output_dir, "config.yml"), "w") as f:
        f.write(cfg.dump())

    model = build_training_model(cfg, device, torch.Generator(device).manual_seed(args.seed))
    if cfg.MODEL.WEIGHT and os.path.exists(cfg.MODEL.WEIGHT):
        load_reference_weights(cfg.MODEL.WEIGHT, model, logger)
        logger.info(f"loaded {cfg.MODEL.WEIGHT}")
    optimizer = make_optimizer(cfg, model)
    scheduler = make_lr_scheduler(cfg, optimizer)
    checkpointer = Checkpointer(args.output_dir, logger)
    start_iter = 0
    if args.resume and checkpointer.has_checkpoint():
        start_iter = checkpointer.restore(
            checkpointer.load(ignore_optimizer=cfg.MODEL.VID.IGNORE), model, optimizer,
            scheduler)

    rng = np.random.RandomState(args.seed)
    dataset = Concat([build_dataset(name, method=method, is_train=True, data_dir=args.data_dir,
                                    rng=rng) for name in cfg.DATASETS.TRAIN])
    prep = TrainPreprocessor(min_size=cfg.INPUT.MIN_SIZE_TRAIN[0],
                             max_size=cfg.INPUT.MAX_SIZE_TRAIN,
                             canvas_short=cfg.TPU.CANVAS_HEIGHT,
                             canvas_long=cfg.TPU.CANVAS_WIDTH, max_gt=cfg.TPU.MAX_GT_BOXES,
                             hflip_prob=cfg.INPUT.HORIZONTAL_FLIP_PROB_TRAIN, rng=rng)
    batches = train_batches(dataset, prep, training_indices(
        len(dataset), orientation_groups(dataset), max(cfg.SOLVER.IMS_PER_BATCH, 1),
        start_iter=start_iter, max_iter=cfg.SOLVER.MAX_ITER, seed=args.seed))
    return do_train(cfg, model, batches, optimizer, scheduler, checkpointer, logger,
                    start_iter=start_iter,
                    generator=torch.Generator(device).manual_seed(args.seed))


if __name__ == "__main__":
    main()
