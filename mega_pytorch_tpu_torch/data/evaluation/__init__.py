"""Dataset-type evaluation dispatch (a copy of
``mega_pytorch_tpu/data/evaluation/__init__.py``).

Counterpart of mega_core/data/datasets/evaluation/__init__.py: route a
{dataset_idx: prediction dict} map to the protocol matching the dataset
family. Predictions are in original image coordinates with "boxes", "labels"
and "scores" (or "objectness" for RPN-only / box_only runs).
"""

from __future__ import annotations

from .coco_eval import eval_detection_coco
from .vid_eval import (
    eval_detection_vid,
    eval_proposals_vid,
    load_motion_ious,
)
from .voc_eval import eval_detection_voc


def evaluate(
    dataset,
    predictions: dict,
    box_only: bool = False,
    motion_iou_path: str | None = None,
    logger=None,
) -> dict:
    """Score `predictions` with the protocol for `dataset`'s family."""
    ids = sorted(predictions.keys())
    gt_list = [dataset.get_groundtruth(i) for i in ids]
    pred_list = [predictions[i] for i in ids]

    name = type(dataset).__name__
    if box_only:
        result = eval_proposals_vid(gt_list, pred_list)
        if logger:
            logger.info(f"Recall: {result['recall']:.4f}")
        return result
    if "COCO" in name or "CityScapes" in name:
        result = eval_detection_coco(gt_list, pred_list)
        if logger:
            logger.info(
                f"AP={result['AP']:.4f} AP50={result['AP50']:.4f} "
                f"AP75={result['AP75']:.4f}"
            )
        return result
    if "VOC" in name:
        # the reference scores VOC with the 07 11-point metric
        # (evaluation/voc/voc_eval.py:26-30)
        result = eval_detection_voc(gt_list, pred_list, use_07_metric=True)
        if logger:
            logger.info(f"mAP: {result['map']:.4f}")
        return result
    # default: ImageNet VID protocol (AP50 + motion buckets)
    motion_ious = load_motion_ious(motion_iou_path) if motion_iou_path else None
    result = eval_detection_vid(gt_list, pred_list, motion_ious=motion_ious)
    if logger:
        for bucket, r in result.items():
            logger.info(f"AP50 | motion={bucket:>6s} = {r['map']:.4f}")
    return result
