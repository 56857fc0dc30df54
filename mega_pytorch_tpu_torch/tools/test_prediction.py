"""Re-evaluate saved predictions without a model (counterpart of the repo's
``tools/test_prediction.py``).

    python -m mega_pytorch_tpu_torch.tools.test_prediction --preset mega_R_101 \\
        --data-dir datasets --predictions output/predictions_0.npz [more shards ...]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    """Rescores the shards' predictions; returns the evaluation result."""
    from ..config import get_preset
    from ..data.paths_catalog import build_dataset
    from ..engine.inference import evaluate_predictions
    from ..utils.logger import setup_logger
    from .test_net import load_predictions

    parser = argparse.ArgumentParser()
    parser.add_argument("--preset", default="mega_R_101")
    parser.add_argument("--data-dir", default="datasets")
    parser.add_argument("--motion-iou-file", default=None)
    parser.add_argument("--predictions", nargs="+", required=True)
    args = parser.parse_args(argv)

    cfg = get_preset(args.preset)
    method = cfg.MODEL.VID.METHOD if cfg.MODEL.VID.ENABLE else "base"
    logger = setup_logger("mega_pytorch_tpu_torch.rescore", None)
    dataset = build_dataset(cfg.DATASETS.TEST[0], method=method, is_train=False,
                            data_dir=args.data_dir)
    preds = load_predictions(args.predictions)
    logger.info(f"loaded {len(preds)} predictions from {len(args.predictions)} shard(s)")
    return evaluate_predictions(dataset, preds, args.motion_iou_file, logger)


if __name__ == "__main__":
    main()
