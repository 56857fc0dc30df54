"""ImageNet VID evaluation: AP50 with motion-IoU buckets (pure numpy; a copy
of ``mega_pytorch_tpu/data/evaluation/vid_eval.py``).

Behavioral parity with mega_core/data/datasets/evaluation/vid/vid_eval.py:
14-343 — the author-modified FGFA motion-IoU protocol:
  * detections matched greedily per class in score order against
    unmatched GT, at IoU >= 0.5 computed on integer boxes (x2/y2 + 1);
  * GT outside the motion range is "ignored": matches to ignored GT don't
    count, unmatched detections closer to ignored GT are ignored, fully
    unmatched detections on GT-free images are soft-weighted by the overall
    in-range fraction (``empty_weight``);
  * AP via the all-points PR-curve area (use_07_metric=False by default).

The per-object motion-IoU table ships with the reference as a .mat file
(vid_groundtruth_motion_iou.mat); pass its path (or a precomputed array) for
motion-specific numbers. It is derived data: the motion IoU of a GT object is
the mean IoU of its box with the same object's boxes ±10 frames away.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

MOTION_RANGES = ((0.0, 1.0), (0.0, 0.7), (0.7, 0.9), (0.9, 1.0))
MOTION_NAMES = ("all", "fast", "medium", "slow")


def _np_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(M, 4) x (N, 4) IoU with the +1 convention."""
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt + 1, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-12)


def load_motion_ious(mat_path: str) -> list:
    """Load the reference's per-image, per-object motion IoU table."""
    import scipy.io as sio

    raw = sio.loadmat(mat_path)["motion_iou"]
    return [
        np.array(
            [row[0][j][0] if len(row[0][j]) != 0 else 0 for j in range(len(row[0]))]
        )
        for row in raw
    ]


def calc_prec_rec(
    gt_list: list[dict],
    pred_list: list[dict],
    motion_ious: list | None,
    iou_thresh: float = 0.5,
    motion_range=(0.0, 1.0),
):
    """gt_list[i]: {boxes, labels}; pred_list[i]: {boxes, labels, scores}."""
    n_pos: dict = defaultdict(float)
    score: dict = defaultdict(list)
    match: dict = defaultdict(list)
    pred_ignore: dict = defaultdict(list)

    if motion_ious is None:
        motion_ious = [None] * len(gt_list)
        empty_weight = 0.0
    else:
        all_iou = np.concatenate(motion_ious, axis=0)
        in_range = (all_iou >= motion_range[0]) & (all_iou <= motion_range[1])
        empty_weight = float(in_range.sum()) / max(len(all_iou), 1)
        if empty_weight == 1:
            empty_weight = 0.0

    for gt, pred, miou in zip(gt_list, pred_list, motion_ious):
        gt_bbox = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)
        gt_label = np.asarray(gt["labels"], int)
        pred_bbox = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)
        pred_label = np.asarray(pred["labels"], int)
        pred_score = np.asarray(pred["scores"], np.float64)

        gt_ignore = np.zeros(len(gt_bbox))
        if miou is not None and len(miou):
            for k in range(len(gt_bbox)):
                if miou[k] < motion_range[0] or miou[k] > motion_range[1]:
                    gt_ignore[k] = 1

        for l in np.unique(np.concatenate([pred_label, gt_label]).astype(int)):
            pm = pred_label == l
            order = pred_score[pm].argsort()[::-1]
            pb = pred_bbox[pm][order]
            ps = pred_score[pm][order]

            gm = gt_label == l
            gb = gt_bbox[gm]
            gi = gt_ignore[gm]

            n_pos[l] += len(gb) - gi.sum()
            score[l].extend(ps)
            if len(pb) == 0:
                continue
            if len(gb) == 0:
                match[l].extend([0] * len(pb))
                pred_ignore[l].extend([empty_weight] * len(pb))
                continue

            # VID evaluates integer boxes: +1 on x2/y2 before IoU
            pb2 = pb.copy()
            pb2[:, 2:] += 1
            gb2 = gb.copy()
            gb2[:, 2:] += 1
            iou = _np_iou(pb2, gb2)

            selec = np.zeros(len(gb), bool)
            for j in range(len(pb)):
                iou_match = iou_thresh
                iou_ig, iou_nig = -1.0, -1.0
                arg = -1
                for k in range(len(gb)):
                    if gi[k] == 1 and iou[j, k] > iou_ig:
                        iou_ig = iou[j, k]
                    if gi[k] == 0 and iou[j, k] > iou_nig:
                        iou_nig = iou[j, k]
                    if selec[k] or iou[j, k] < iou_match:
                        continue
                    if iou[j, k] == iou_match:
                        if arg < 0 or gi[arg]:
                            arg = k
                    else:
                        arg = k
                    iou_match = iou[j, k]
                if arg >= 0:
                    match[l].append(1)
                    pred_ignore[l].append(gi[arg])
                    selec[arg] = True
                else:
                    if iou_nig > iou_ig:
                        pred_ignore[l].append(0)
                    elif iou_ig > iou_nig:
                        pred_ignore[l].append(1)
                    else:
                        pred_ignore[l].append(gi.sum() / float(len(gb)))
                    match[l].append(0)

    n_fg = max(n_pos.keys()) + 1
    prec = [None] * n_fg
    rec = [None] * n_fg
    for l in n_pos:
        sl = np.asarray(score[l])
        ml = np.asarray(match[l], np.int8)
        il = np.asarray(pred_ignore[l], np.float64)
        order = sl.argsort()[::-1]
        ml, il = ml[order], il[order]

        tps = np.logical_and(ml == 1, il != 1)
        fps = np.logical_and(ml == 0, il != 1).astype(np.float64)
        il = il.copy()
        il[il == 0] = 1
        fps = fps * il

        tp = np.cumsum(tps)
        fp = np.cumsum(fps)
        prec[l] = tp / (fp + tp + np.spacing(1))
        if n_pos[l] > 0:
            rec[l] = tp / n_pos[l]
    return prec, rec


def calc_ap(prec, rec, use_07_metric: bool = False) -> np.ndarray:
    n_fg = len(prec)
    ap = np.empty(n_fg)
    for l in range(n_fg):
        if prec[l] is None or rec[l] is None:
            ap[l] = np.nan
            continue
        if use_07_metric:
            ap[l] = 0.0
            for t in np.arange(0.0, 1.1, 0.1):
                if np.sum(rec[l] >= t) == 0:
                    p = 0.0
                else:
                    p = np.max(np.nan_to_num(prec[l])[rec[l] >= t])
                ap[l] += p / 11
        else:
            mpre = np.concatenate(([0], np.nan_to_num(prec[l]), [0]))
            mrec = np.concatenate(([0], rec[l], [1]))
            mpre = np.maximum.accumulate(mpre[::-1])[::-1]
            i = np.where(mrec[1:] != mrec[:-1])[0]
            ap[l] = np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1])
    return ap


def eval_proposals_vid(
    gt_list: list[dict],
    pred_list: list[dict],
    iou_thresh: float = 0.5,
    limit: int = 300,
) -> dict:
    """Class-agnostic proposal recall (the reference's --box_only path,
    evaluation/vid/vid_eval.py:73-110): per image, greedily assign each GT its
    best remaining proposal (highest-IoU pair first), then recall = fraction
    of GT covered at >= iou_thresh. Proposals are score-sorted and capped at
    `limit`. pred dicts carry "objectness" (RPN-only output) or "scores"."""
    assert len(gt_list) == len(pred_list)
    gt_overlaps = []
    num_pos = 0
    for gt, pred in zip(gt_list, pred_list):
        gb = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)
        pb = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)
        scores = np.asarray(
            pred.get("objectness", pred.get("scores", np.zeros(len(pb))))
        ).reshape(-1)
        order = np.argsort(-scores, kind="stable")[:limit]
        pb = pb[order]
        num_pos += len(gb)
        if len(gb) == 0 or len(pb) == 0:
            continue
        iou = _np_iou(pb, gb)  # (P, G)
        covered = np.zeros(len(gb))
        for j in range(min(len(pb), len(gb))):
            per_gt = iou.max(axis=0)  # best proposal per GT
            gi = int(per_gt.argmax())  # GT with the best remaining cover
            pi = int(iou[:, gi].argmax())
            covered[j] = iou[pi, gi]
            iou[pi, :] = -1
            iou[:, gi] = -1
        gt_overlaps.append(covered)
    flat = np.concatenate(gt_overlaps) if gt_overlaps else np.zeros(0)
    recall = float((flat >= iou_thresh).sum() / max(num_pos, 1))
    return {"recall": recall, "gt_overlaps": np.sort(flat)}


def eval_detection_vid(
    gt_list: list[dict],
    pred_list: list[dict],
    motion_ious: list | None = None,
    iou_thresh: float = 0.5,
    use_07_metric: bool = False,
) -> dict:
    """Returns {motion_name: {"ap": per-class array, "map": mean}}."""
    assert len(gt_list) == len(pred_list)
    ranges = MOTION_RANGES if motion_ious is not None else ((0.0, 1.0),)
    names = MOTION_NAMES if motion_ious is not None else ("all",)
    out = {}
    for name, rng in zip(names, ranges):
        prec, rec = calc_prec_rec(gt_list, pred_list, motion_ious, iou_thresh, rng)
        ap = calc_ap(prec, rec, use_07_metric)
        # Classes with zero GT in this motion bucket are NaN by construction;
        # average only the scored classes. A bucket where no class is scored
        # (every object ignored) yields an explicit NaN map rather than the
        # "Mean of empty slice" RuntimeWarning of nanmean.
        scored = np.isfinite(ap)
        out[name] = {
            "ap": ap,
            "map": float(ap[scored].mean()) if scored.any() else float("nan"),
        }
    return out
