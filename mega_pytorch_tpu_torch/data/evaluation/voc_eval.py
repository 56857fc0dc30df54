"""Pascal VOC detection evaluation (pure numpy; a copy of
``mega_pytorch_tpu/data/evaluation/voc_eval.py``).

Behavioral parity with mega_core/data/datasets/evaluation/voc/voc_eval.py
(the chainercv-derived protocol): per-class greedy matching in score order at
IoU >= thresh on integer boxes (+1 on x2/y2), "difficult" GT neither counts as
a positive nor penalizes a match, AP via the 11-point (07) or all-points
metric.

Predictions/GT are plain dicts (our padded structures already converted):
  pred: {"boxes": (P, 4), "labels": (P,), "scores": (P,)}
  gt:   {"boxes": (G, 4), "labels": (G,), "difficult": (G,) optional}
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from .vid_eval import _np_iou, calc_ap


def calc_voc_prec_rec(gt_list, pred_list, iou_thresh: float = 0.5):
    n_pos: dict = defaultdict(int)
    score: dict = defaultdict(list)
    match: dict = defaultdict(list)
    for gt, pred in zip(gt_list, pred_list):
        p_boxes = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)
        p_labels = np.asarray(pred["labels"], np.int64).reshape(-1)
        p_scores = np.asarray(pred["scores"], np.float64).reshape(-1)
        g_boxes = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)
        g_labels = np.asarray(gt["labels"], np.int64).reshape(-1)
        g_diff = np.asarray(
            gt.get("difficult", np.zeros(len(g_boxes), bool))
        ).astype(bool).reshape(-1)

        for l in np.unique(np.concatenate((p_labels, g_labels))):
            sel_p = p_labels == l
            pb, ps = p_boxes[sel_p], p_scores[sel_p]
            order = ps.argsort()[::-1]
            pb, ps = pb[order], ps[order]
            sel_g = g_labels == l
            gb, gd = g_boxes[sel_g], g_diff[sel_g]

            n_pos[l] += int(np.logical_not(gd).sum())
            score[l].extend(ps)
            if len(pb) == 0:
                continue
            if len(gb) == 0:
                match[l].extend([0] * len(pb))
                continue

            pb2 = pb.copy()
            pb2[:, 2:] += 1
            gb2 = gb.copy()
            gb2[:, 2:] += 1
            iou = _np_iou(pb2, gb2)
            gt_index = iou.argmax(axis=1)
            gt_index[iou.max(axis=1) < iou_thresh] = -1

            selec = np.zeros(len(gb), bool)
            for gi in gt_index:
                if gi >= 0:
                    if gd[gi]:
                        match[l].append(-1)
                    elif not selec[gi]:
                        match[l].append(1)
                    else:
                        match[l].append(0)
                    selec[gi] = True
                else:
                    match[l].append(0)

    if not n_pos:  # no labels anywhere: empty gt and empty predictions
        return [], []
    n_fg = max(n_pos.keys()) + 1
    prec = [None] * n_fg
    rec = [None] * n_fg
    for l in n_pos:
        sl = np.asarray(score[l])
        ml = np.asarray(match[l], np.int8)
        order = sl.argsort()[::-1]
        ml = ml[order]
        tp = np.cumsum(ml == 1)
        fp = np.cumsum(ml == 0)
        prec[l] = tp / np.maximum(tp + fp, np.spacing(1))
        if n_pos[l] > 0:
            rec[l] = tp / n_pos[l]
    return prec, rec


def eval_detection_voc(gt_list, pred_list, iou_thresh: float = 0.5,
                       use_07_metric: bool = False) -> dict:
    assert len(gt_list) == len(pred_list)
    prec, rec = calc_voc_prec_rec(gt_list, pred_list, iou_thresh)
    ap = calc_ap(prec, rec, use_07_metric)
    scored = np.isfinite(ap)
    return {
        "ap": ap,
        "map": float(ap[scored].mean()) if scored.any() else float("nan"),
    }
