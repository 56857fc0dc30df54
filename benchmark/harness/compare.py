"""How far a run's detections lie from the reference's.

Random weights leave many detections near-tied, so which of two similar
boxes survives an NMS, and which of the near-tied scores make the top
300, changes with the last bits of the arithmetic. The numbers therefore
judge the program's detections rather than match them one to one:

- ``tf_gap``: each detection (box b, label l, score s) of the program is
  scored again by the reference, which runs b as an extra ROI of the same
  frame through the same layers (ROIAlign, fc, the attention stages
  against the reference's own window, memory and global cache, the
  predictor): |s - p_ref(l | b)| / p_ref(l | b), over every detection of
  every compared frame (``tf_gap_mean``, ``tf_gap_p99``);
- ``nms_excess``: the largest IoU of two program detections of one label,
  less the NMS threshold, at least 0 (greedy NMS keeps no such pair;
  ``nms_excess_max`` over frames);

and hold what the program emits against the reference's own detections:

- ``count_gap``: |program's valid detections - reference's| / reference's,
  a frame (``count_gap_max`` over frames): a frame returns the top
  ``detections_per_img`` of the candidates that survive the per-class NMS,
  and ``candidates_min`` (the fewest such candidates in a compared frame of
  the reference) shows how far that cap binds;
- ``miss_100``: the share of the reference's 100 best detections (by
  score) that no program detection of the same label covers at IoU 0.5 or
  more (``miss_100_mean`` over frames)."""

from __future__ import annotations

import numpy as np
import torch


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x, np.float64)


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt + 1, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-12)


MISS_TOP = 100


def _dets(d: dict) -> dict:
    return {k: _np(d[k]) for k in ("boxes", "scores", "labels")}


def _misses(prog: dict, ref: dict, top: int) -> float:
    """Share of the reference's top ``top`` detections with no program
    detection of the same label at IoU >= 0.5 (0 where the reference has none)."""
    n = min(top, len(ref["labels"]))
    if not n:
        return 0.0
    if not len(prog["labels"]):
        return 1.0
    same = ref["labels"][:n, None].astype(int) == prog["labels"][None, :].astype(int)
    cover = np.where(same, _iou(ref["boxes"][:n], prog["boxes"]), 0.0).max(1) >= 0.5
    return float(1.0 - cover.mean())


def frame_stats(prog: dict, probs, ref: dict, nms: float) -> dict:
    """prog: {"boxes" (N, 4), "scores" (N,), "labels" (N,)}, the program's
    valid detections; probs (N, C): the reference's class probabilities at
    its boxes; ref: the reference's own detections of the frame (with
    "candidates") → {"tf": the N score gaps, "nms_excess", "count_gap",
    "candidates", "miss_100"}."""
    p, r = _dets(prog), _dets(ref)
    lab = p["labels"].astype(int)
    out = {"tf": np.zeros(0), "nms_excess": 0.0, "candidates": int(ref["candidates"]),
           "count_gap": abs(len(lab) - len(r["labels"])) / max(len(r["labels"]), 1)}
    out[f"miss_{MISS_TOP}"] = _misses(p, r, MISS_TOP)
    if not len(lab):
        return out
    pr = _np(probs)[np.arange(len(lab)), lab]
    out["tf"] = np.abs(p["scores"] - pr) / np.maximum(pr, 1e-12)
    same = (lab[:, None] == lab[None, :]) & ~np.eye(len(lab), dtype=bool)
    overlap = np.where(same, _iou(p["boxes"], p["boxes"]), 0.0).max()
    out["nms_excess"] = max(0.0, float(overlap) - nms)
    return out


def run_stats(triples: list, nms: float = 0.5) -> dict:
    """[(prog, probs, ref)] of the compared frames → the run's numbers."""
    per = [frame_stats(p, q, r, nms) for p, q, r in triples]
    tf = np.concatenate([f["tf"] for f in per]) if per else np.zeros(0)
    out = {"frames": len(per), "detections": int(tf.size)}
    if tf.size:
        out.update(tf_gap_mean=float(tf.mean()), tf_gap_p99=float(np.percentile(tf, 99)))
    if per:
        out["nms_excess_max"] = max(f["nms_excess"] for f in per)
        out["count_gap_max"] = max(f["count_gap"] for f in per)
        out["candidates_min"] = min(f["candidates"] for f in per)
        out[f"miss_{MISS_TOP}_mean"] = float(np.mean([f[f"miss_{MISS_TOP}"] for f in per]))
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, list]:
    """correct, and [(name, number, limit)] of every compared number: each
    must be at most its limit (a missing or non-finite number fails)."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        good = bool(np.isfinite(value) and value <= limit)
        ok &= good
        rows.append((name, value, limit))
    return ok, rows
