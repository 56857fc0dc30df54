"""Evaluation entry point (counterpart of the repo's ``tools/test_net.py``).

    python -m mega_pytorch_tpu_torch.tools.test_net --preset mega_R_101 \\
        --data-dir datasets --lanes 12 [--config-file F] [opts ...]

Builds the detector from the config, loads ``MODEL.WEIGHT`` (or
``--checkpoint``), a mega.pytorch ``.pth``, when the file exists (else the
weights are drawn from ``--seed``), reads the VID index and annotations,
preprocesses frames as the JAX package does, and streams whole videos of
this shard through the lockstep engine (``--lanes`` > 1) or the serial
engine (the base method, or one lane); with ``TEST.BBOX_AUG.ENABLED`` (the
base method only) each frame runs test-time augmentation instead
(``engine/bbox_aug.py``: the base size and ``TEST.BBOX_AUG.SCALES``, flips
by ``H_FLIP`` / ``SCALE_H_FLIP``). Writes ``predictions_{shard}.npz``
and, with one shard, ``result.txt`` and ``result.json``, logging AP50 per
motion bucket. The run takes the CUDA card unless ``--device cpu`` is given,
and fails where there is none.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="video detection eval on the card")
    parser.add_argument("--preset", default="mega_R_101")
    parser.add_argument("--config-file", action="append", default=None)
    parser.add_argument("--checkpoint", default=None,
                        help="a mega.pytorch .pth to load in place of MODEL.WEIGHT")
    parser.add_argument("--data-dir", default="datasets")
    parser.add_argument("--output-dir", default="output")
    parser.add_argument("--motion-iou-file", default=None)
    parser.add_argument("--box-only", action="store_true",
                        help="score class-agnostic proposal recall instead of AP")
    parser.add_argument("--lanes", type=int, default=12,
                        help="parallel video lanes for lockstep streaming")
    parser.add_argument("--shard", type=int, default=0)
    parser.add_argument("--num-shards", type=int, default=1)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; nothing falls back to the CPU")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the weights drawn when no checkpoint is "
                        "loaded, and of MEGA's global-frame schedule")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return parser.parse_args(argv)


def load_config(args):
    from ..config import get_preset

    cfg = get_preset(args.preset)
    for path in args.config_file or ():
        cfg.merge_from_file(path)
    opts = args.opts[1:] if args.opts and args.opts[0] == "opts" else args.opts
    if opts:
        cfg.merge_from_list(opts)
    return cfg.freeze()


def dataset_kwargs(cfg, method: str, seed: int) -> dict:
    """The test-time sampling the config sets for the method's dataset."""
    v = cfg.MODEL.VID
    if method == "mega":
        return dict(max_offset=v.MEGA.MAX_OFFSET, all_frame_interval=v.MEGA.ALL_FRAME_INTERVAL,
                    global_size=v.MEGA.GLOBAL.SIZE, global_enable=v.MEGA.GLOBAL.ENABLE,
                    global_shuffle=v.MEGA.GLOBAL.SHUFFLE, global_seed=seed)
    if method in ("rdn", "fgfa"):
        return dict(max_offset=(v.RDN if method == "rdn" else v.FGFA).MAX_OFFSET)
    if method == "dff":
        return dict(key_interval=v.DFF.KEY_FRAME_INTERVAL)
    return {}


def video_starts(dataset) -> list[int]:
    """Dataset indices where a video begins ([0] for an image set)."""
    if not dataset.is_video:
        return [0]
    return [i for i, name in enumerate(dataset.image_set_index)
            if int(name.split("/")[-1]) == 0]


def main(argv=None) -> dict:
    """Runs the evaluation; returns {"predictions": ..., "result": ... or None}."""
    from ..data.loader import eval_preprocessor
    from ..data.paths_catalog import build_dataset
    from ..data.samplers import video_shards
    from ..engine.inference import compute_on_dataset, evaluate_predictions
    from ..models.detectors import build_detection_model
    from ..utils.logger import setup_logger
    from ..utils.model_ingest import load_reference_weights

    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("test_net: no CUDA card here; --device cpu runs on the CPU")
    cfg = load_config(args)
    method = cfg.MODEL.VID.METHOD if cfg.MODEL.VID.ENABLE else "base"
    if cfg.TEST.BBOX_AUG.ENABLED and method != "base":
        raise ValueError(f"TEST.BBOX_AUG is single-frame only (the base method), not {method!r}")
    logger = setup_logger("mega_pytorch_tpu_torch.eval", args.output_dir)
    logger.info(f"{args.preset} ({method}) on {device}"
                + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))

    model = build_detection_model(cfg, device, torch.Generator(device).manual_seed(args.seed),
                                  lanes=args.lanes)
    weight = args.checkpoint or cfg.MODEL.WEIGHT
    if weight and os.path.exists(weight):
        load_reference_weights(weight, model, logger)
        logger.info(f"loaded {weight}")
    else:
        logger.info(f"no checkpoint at {weight!r}: weights drawn from seed {args.seed}")

    dataset = build_dataset(cfg.DATASETS.TEST[0], method=method, is_train=False,
                            data_dir=args.data_dir, **dataset_kwargs(cfg, method, args.seed))
    prep = eval_preprocessor(cfg)
    indices = video_shards(video_starts(dataset), len(dataset), args.num_shards)[args.shard]
    logger.info(f"shard {args.shard}/{args.num_shards}: {len(indices)} frames")

    if cfg.TEST.BBOX_AUG.ENABLED:
        preds = bbox_aug_on_dataset(model, dataset, indices, cfg, logger)
    else:
        preds = compute_on_dataset(model, dataset, indices, prep, method, logger,
                                   lanes=args.lanes)
    os.makedirs(args.output_dir, exist_ok=True)
    save_predictions(preds, os.path.join(args.output_dir, f"predictions_{args.shard}.npz"))
    result = None
    if args.num_shards == 1:
        result = evaluate_predictions(dataset, preds, args.motion_iou_file, logger,
                                      box_only=args.box_only)
        write_result(result, args.output_dir, box_only=args.box_only)
    return {"predictions": preds, "result": result}


def bbox_aug_on_dataset(model, dataset, indices, cfg, logger=None) -> dict:
    """Test-time augmentation of each frame of ``indices`` (the JAX
    ``tools/test_net.py`` loop) → {dataset_idx: prediction dict}."""
    from ..engine.bbox_aug import im_detect_bbox_aug

    aug = cfg.TEST.BBOX_AUG
    preds = {}
    for n, i in enumerate(indices):
        preds[i] = im_detect_bbox_aug(
            model, dataset.load_image(i),
            scales=(cfg.INPUT.MIN_SIZE_TEST,) + tuple(aug.SCALES), max_size=aug.MAX_SIZE,
            canvas_short=cfg.TPU.CANVAS_HEIGHT, canvas_long=cfg.TPU.CANVAS_WIDTH,
            hflip=aug.H_FLIP, scale_hflip=aug.SCALE_H_FLIP,
            nms_thresh=cfg.MODEL.ROI_HEADS.NMS,
            detections_per_img=cfg.TEST.DETECTIONS_PER_IMG)
        if logger and n % 100 == 0:
            logger.info(f"bbox-aug {n}/{len(indices)}")
    return preds


def save_predictions(preds: dict, path: str) -> None:
    """The JAX package's format: an object array of (idx, boxes, scores,
    labels) rows, so either package's ``test_prediction`` reads it."""
    np.savez_compressed(path, predictions=np.asarray(
        [(k, v["boxes"], v["scores"], v["labels"]) for k, v in preds.items()],
        dtype=object))


def load_predictions(paths) -> dict:
    """``save_predictions`` files (this program's own output) → {idx: dict}."""
    preds: dict = {}
    for path in paths:
        with np.load(path, allow_pickle=True) as z:
            for idx, boxes, scores, labels in z["predictions"]:
                preds[int(idx)] = {"boxes": boxes, "scores": scores, "labels": labels}
    return preds


def write_result(result: dict, output_dir: str, box_only: bool = False) -> None:
    """Serialize an evaluation result, whatever its family shape: VID nested
    {bucket: {'map', 'ap'}}, COCO {'AP', ...}, VOC {'map', 'ap'}, box_only
    {'recall', 'gt_overlaps'}. result.txt gets human-readable summary lines;
    result.json the full dict with arrays as lists."""
    lines = []
    if box_only:
        lines.append(f"Proposal recall = {float(result['recall']):.4f}")
    elif result and all(isinstance(v, dict) for v in result.values()):
        for mname, r in result.items():  # VID motion buckets
            lines.append(f"AP50 | motion={mname:>6s} = {float(r['map']):.4f}")
    else:
        for key in ("AP", "AP50", "AP75", "APs", "APm", "APl", "map"):
            if key in result and np.isscalar(result[key]):
                lines.append(f"{key} = {float(result[key]):.4f}")

    def jsonable(obj):
        if isinstance(obj, dict):
            return {str(k): jsonable(v) for k, v in obj.items()}
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if isinstance(obj, (np.floating, np.integer)):
            return obj.item()
        return obj

    with open(os.path.join(output_dir, "result.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(output_dir, "result.json"), "w") as f:
        json.dump(jsonable(result), f, indent=1)


if __name__ == "__main__":
    main()
