"""The port's evaluation protocols against the JAX package's, on the same
seeded ground truth and predictions: ImageNet VID AP50 with and without the
motion buckets (ignored GT, tied scores, images without GT), proposal
recall, VOC and COCO, ``evaluate``'s dispatch, ``load_motion_ious`` and
``evaluate_predictions``. Every number equals JAX's to 1e-12."""

import numpy as np
import pytest
import scipy.io as sio

from mega_pytorch_tpu.data import evaluation as jax_eval
from mega_pytorch_tpu.data.evaluation import coco_eval as jax_coco
from mega_pytorch_tpu.data.evaluation import vid_eval as jax_vid_eval
from mega_pytorch_tpu.data.evaluation import voc_eval as jax_voc
from mega_pytorch_tpu.engine.inference import evaluate_predictions as jax_evaluate_predictions
from mega_pytorch_tpu_torch.data import evaluation
from mega_pytorch_tpu_torch.data.evaluation import coco_eval, vid_eval, voc_eval
from mega_pytorch_tpu_torch.engine.inference import evaluate_predictions

TOL = 1e-12


def _boxes(rs, n, size=100.0):
    xy = rs.rand(n, 2) * size
    wh = rs.rand(n, 2) * size / 2 + 2
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _case(seed, n_img=12, n_cls=4):
    """GT and predictions: some images without GT, detections near GT,
    scores with ties, and per-GT motion IoUs spread over the buckets."""
    rs = np.random.RandomState(seed)
    gts, preds, mious = [], [], []
    for i in range(n_img):
        g = 0 if i % 5 == 3 else rs.randint(1, 5)
        gb = _boxes(rs, g)
        gl = rs.randint(1, n_cls + 1, g)
        hit = rs.randint(0, g, rs.randint(0, 4)) if g else np.zeros(0, int)
        near = gb[hit]
        pb = np.concatenate([near + rs.randn(*near.shape) * 2, _boxes(rs, rs.randint(0, 4))])
        pl = np.concatenate([gl[hit], rs.randint(1, n_cls + 1, len(pb) - len(near))])
        scores = np.round(rs.rand(len(pb)), 1)  # ties across images and classes
        gts.append({"boxes": gb, "labels": gl.astype(np.int64),
                    "difficult": rs.rand(g) < 0.2, "iscrowd": rs.rand(g) < 0.15})
        preds.append({"boxes": pb.astype(np.float32), "labels": pl.astype(np.int64),
                      "scores": scores.astype(np.float32),
                      "objectness": scores.astype(np.float32)})
        mious.append(rs.rand(g))
    return gts, preds, mious


def _assert_equal(got, want, where="result"):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _assert_equal(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal(g, w, f"{where}[{i}]")
    elif want is None:
        assert got is None, where
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                                   rtol=0, atol=TOL, err_msg=where)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("motion", [False, True])
def test_eval_detection_vid_equals_jax(seed, motion):
    gts, preds, mious = _case(seed)
    m = mious if motion else None
    _assert_equal(vid_eval.eval_detection_vid(gts, preds, motion_ious=m),
                  jax_vid_eval.eval_detection_vid(gts, preds, motion_ious=m))
    prec, rec = vid_eval.calc_prec_rec(gts, preds, m, 0.5, (0.0, 0.7))
    _assert_equal((prec, rec), jax_vid_eval.calc_prec_rec(gts, preds, m, 0.5, (0.0, 0.7)))
    for use_07 in (False, True):
        _assert_equal(vid_eval.calc_ap(prec, rec, use_07), jax_vid_eval.calc_ap(prec, rec, use_07))


def test_eval_proposals_vid_equals_jax():
    for seed in range(3):
        gts, preds, _ = _case(seed)
        for limit in (300, 2):
            _assert_equal(vid_eval.eval_proposals_vid(gts, preds, limit=limit),
                          jax_vid_eval.eval_proposals_vid(gts, preds, limit=limit))


def test_voc_and_coco_equal_jax():
    for seed in range(3):
        gts, preds, _ = _case(seed)
        for use_07 in (False, True):
            _assert_equal(voc_eval.eval_detection_voc(gts, preds, use_07_metric=use_07),
                          jax_voc.eval_detection_voc(gts, preds, use_07_metric=use_07))
        for area in ("all", "small", "medium", "large"):
            try:
                want = jax_coco.eval_detection_coco(gts, preds, max_dets=3, area_range=area)
            except IndexError:  # every detection of a class ignored: raises in both
                with pytest.raises(IndexError):
                    coco_eval.eval_detection_coco(gts, preds, max_dets=3, area_range=area)
                continue
            _assert_equal(coco_eval.eval_detection_coco(gts, preds, max_dets=3,
                                                        area_range=area), want)
    empty = [{"boxes": np.zeros((0, 4)), "labels": np.zeros(0, int)}]
    none = [{"boxes": np.zeros((0, 4)), "labels": np.zeros(0, int), "scores": np.zeros(0)}]
    _assert_equal(voc_eval.eval_detection_voc(empty, none), jax_voc.eval_detection_voc(empty, none))
    _assert_equal(coco_eval.eval_detection_coco(empty, none),
                  jax_coco.eval_detection_coco(empty, none))


class _Set:
    """A dataset stand-in: the family comes from the class name."""

    def __init__(self, gts):
        self.gts = gts

    def get_groundtruth(self, i):
        return self.gts[i]


@pytest.mark.parametrize("family", ["VIDMEGADataset", "COCODataset", "PascalVOCDataset"])
def test_evaluate_dispatch_equals_jax(family, tmp_path):
    """``evaluate`` and ``evaluate_predictions`` route each family to its
    protocol (VID with a motion-IoU file, box_only to proposal recall), on
    predictions keyed out of order."""
    gts, preds, mious = _case(5)
    ds = type(family, (_Set,), {})(gts)
    predictions = {i: preds[i] for i in reversed(range(len(preds)))}
    mat = tmp_path / "motion.mat"
    cells = np.empty((len(mious), 1), object)
    for i, m in enumerate(mious):  # one (objects, 1) column per image
        cells[i, 0] = np.asarray(m, np.float64).reshape(-1, 1)
    sio.savemat(mat, {"motion_iou": cells})
    _assert_equal(vid_eval.load_motion_ious(str(mat)), jax_vid_eval.load_motion_ious(str(mat)))
    for box_only in (False, True):
        _assert_equal(evaluation.evaluate(ds, predictions, box_only=box_only,
                                          motion_iou_path=str(mat)),
                      jax_eval.evaluate(ds, predictions, box_only=box_only,
                                        motion_iou_path=str(mat)))
        _assert_equal(evaluate_predictions(ds, predictions, str(mat), box_only=box_only),
                      jax_evaluate_predictions(ds, predictions, str(mat), box_only=box_only))
