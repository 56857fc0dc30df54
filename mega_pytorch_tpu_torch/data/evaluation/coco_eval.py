"""COCO-protocol bbox evaluation (pure numpy, no pycocotools dependency; a
copy of ``mega_pytorch_tpu/data/evaluation/coco_eval.py``).

Counterpart of mega_core/data/datasets/evaluation/coco/coco_eval.py, which
wraps pycocotools' COCOeval. This image doesn't ship pycocotools, so the bbox
protocol is implemented directly:
  * 10 IoU thresholds 0.50:0.05:0.95, per-class greedy matching in score
    order (each detection takes the highest-IoU unmatched GT above thresh)
  * iscrowd GT can be matched many times and never counts as FP or positive
  * precision envelope sampled at 101 recall points, averaged over classes
    and thresholds; AP = mean over thresholds, AP50/AP75 at fixed thresholds
  * maxDets cap (100) per image, area ranges (all/small/medium/large)

IoU here is the COCO convention (no +1): boxes are xyxy floats.

Predictions/GT are dicts: pred {"boxes","labels","scores"},
gt {"boxes","labels","iscrowd" optional, "areas" optional}.
"""

from __future__ import annotations

import numpy as np

IOU_THRESHS = np.arange(0.5, 1.0, 0.05)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, float("inf")),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, float("inf")),
}


def _iou_xyxy(a: np.ndarray, b: np.ndarray, b_crowd: np.ndarray) -> np.ndarray:
    """COCO IoU; for crowd GT the denominator is the detection area only."""
    area_a = np.maximum(a[:, 2] - a[:, 0], 0) * np.maximum(a[:, 3] - a[:, 1], 0)
    area_b = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(b[:, 3] - b[:, 1], 0)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = np.where(
        b_crowd[None, :], area_a[:, None], area_a[:, None] + area_b[None, :] - inter
    )
    return inter / np.maximum(union, 1e-12)


def _match_image(pb, ps, gb, g_crowd, g_ignore, iou_threshs):
    """Greedy per-threshold matching for one (image, class).

    Returns (dt_matched (T, P) bool, dt_ignore (T, P) bool, n_gt)."""
    T, P, G = len(iou_threshs), len(pb), len(gb)
    dt_m = np.zeros((T, P), bool)
    dt_ig = np.zeros((T, P), bool)
    n_gt = int((~g_ignore).sum())
    if P == 0:
        return dt_m, dt_ig, n_gt
    if G == 0:
        return dt_m, dt_ig, n_gt
    # gt sorted: real GT before ignored (pycocotools sorts by _ignore)
    g_order = np.argsort(g_ignore, kind="stable")
    gb, g_crowd, g_ignore = gb[g_order], g_crowd[g_order], g_ignore[g_order]
    ious = _iou_xyxy(pb, gb, g_crowd)
    for ti, t in enumerate(iou_threshs):
        g_taken = np.zeros(G, bool)
        for di in range(P):
            best, bi = min(t, 1 - 1e-10), -1
            for gi in range(G):
                # already taken (crowds may be reused)
                if g_taken[gi] and not g_crowd[gi]:
                    continue
                # real matches found and now into ignored gt: stop
                if bi > -1 and not g_ignore[bi] and g_ignore[gi]:
                    break
                if ious[di, gi] < best:
                    continue
                best, bi = ious[di, gi], gi
            if bi == -1:
                continue
            g_taken[bi] = True
            dt_m[ti, di] = True
            dt_ig[ti, di] = g_ignore[bi]
    return dt_m, dt_ig, n_gt


def eval_detection_coco(
    gt_list, pred_list, max_dets: int = 100, area_range: str = "all"
) -> dict:
    """Returns {"AP", "AP50", "AP75", "ap_per_class": {label: (T,) array}}."""
    assert len(gt_list) == len(pred_list)
    lo, hi = AREA_RANGES[area_range]
    labels = sorted(
        {int(l) for gt in gt_list for l in np.asarray(gt["labels"]).reshape(-1)}
    )
    T = len(IOU_THRESHS)
    ap_per_class = {}
    for cls in labels:
        scores_all, m_all, ig_all, n_gt = [], [], [], 0
        for gt, pred in zip(gt_list, pred_list):
            g_sel = np.asarray(gt["labels"]).reshape(-1) == cls
            gb = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)[g_sel]
            g_crowd = np.asarray(
                gt.get("iscrowd", np.zeros(len(g_sel), bool))
            ).astype(bool).reshape(-1)[g_sel]
            areas = np.asarray(
                gt.get(
                    "areas",
                    (gb[:, 2] - gb[:, 0]) * (gb[:, 3] - gb[:, 1])
                    if len(gb)
                    else np.zeros(0),
                )
            ).reshape(-1)
            g_ignore = g_crowd | (areas < lo) | (areas > hi)

            p_sel = np.asarray(pred["labels"]).reshape(-1) == cls
            pb = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)[p_sel]
            ps = np.asarray(pred["scores"], np.float64).reshape(-1)[p_sel]
            order = np.argsort(-ps, kind="stable")[:max_dets]
            pb, ps = pb[order], ps[order]

            dt_m, dt_ig, n = _match_image(pb, ps, gb, g_crowd, g_ignore, IOU_THRESHS)
            # unmatched detections outside the area range are ignored too
            p_area = (pb[:, 2] - pb[:, 0]) * (pb[:, 3] - pb[:, 1])
            out = (p_area < lo) | (p_area > hi)
            dt_ig = dt_ig | (~dt_m & out[None, :])
            scores_all.append(ps)
            m_all.append(dt_m)
            ig_all.append(dt_ig)
            n_gt += n
        if n_gt == 0:
            continue
        scores = np.concatenate(scores_all)
        m = np.concatenate(m_all, axis=1)
        ig = np.concatenate(ig_all, axis=1)
        order = np.argsort(-scores, kind="mergesort")
        m, ig = m[:, order], ig[:, order]

        ap_t = np.zeros(T)
        for ti in range(T):
            keep = ~ig[ti]
            tp = np.cumsum(m[ti][keep])
            fp = np.cumsum(~m[ti][keep])
            rec = tp / n_gt
            prec = tp / np.maximum(tp + fp, np.spacing(1))
            # precision envelope, sampled at the 101 recall points
            for i in range(len(prec) - 1, 0, -1):
                prec[i - 1] = max(prec[i - 1], prec[i])
            idx = np.searchsorted(rec, RECALL_POINTS, side="left")
            q = np.where(idx < len(prec), prec[np.minimum(idx, len(prec) - 1)], 0.0)
            ap_t[ti] = q.mean()
        ap_per_class[cls] = ap_t

    if not ap_per_class:
        nan = float("nan")
        return {"AP": nan, "AP50": nan, "AP75": nan, "ap_per_class": {}}
    stacked = np.stack(list(ap_per_class.values()))  # (C, T)
    return {
        "AP": float(stacked.mean()),
        "AP50": float(stacked[:, 0].mean()),
        "AP75": float(stacked[:, 5].mean()),
        "ap_per_class": ap_per_class,
    }
