"""Test-time augmentation against the JAX package, on the CPU.

``im_detect_bbox_aug`` of the port and of the JAX package on the same
``tiny_root`` frame with the same bridged base detector (f32): the run
schedule of ``tests/test_engine.py::test_im_detect_bbox_aug`` (the base
scale plain and flipped, the extra scale plain) and the merged boxes,
scores and labels; then ``test_net.main`` with ``TEST.BBOX_AUG.ENABLED``
equal to direct calls, and a video method refused.
"""

import jax
import numpy as np
import pytest
import torch

from mega_pytorch_tpu.data.datasets.vid import VIDDataset as JaxVIDDataset
from mega_pytorch_tpu.data.loader import EvalPreprocessor as JaxEvalPreprocessor
from mega_pytorch_tpu.engine.bbox_aug import im_detect_bbox_aug as jax_bbox_aug
from mega_pytorch_tpu.engine.trainer import assemble_inputs
from mega_pytorch_tpu.models.detectors.rcnn import GeneralizedRCNN as JaxRCNN
from mega_pytorch_tpu.utils.misc import jit_init
from mega_pytorch_tpu_torch.config import get_preset
from mega_pytorch_tpu_torch.engine.bbox_aug import im_detect_bbox_aug
from mega_pytorch_tpu_torch.models.detectors import build_detection_model
from mega_pytorch_tpu_torch.models.detectors.rcnn import GeneralizedRCNN
from mega_pytorch_tpu_torch.tools import test_net
from test_engine import TINY_C, _prep_kwargs
from test_torch_config import TINY_OPTS
from torch_port_harness import (
    _perturb,
    dataset_args,
    ilsvrc_data_dir,
    port_configs,
    port_dataset,
    port_model_from,
    to_np,
)

torch.set_num_threads(2)

# the port runs each canvas s2d(4)-packed (the 3x3 stem form), JAX the
# 7x7/2 form: the same f32 sums in another order, so scores and boxes
# (x up to 64 px) agree to float noise, and the merged sets are the same
ATOL_SCORE, ATOL_BOX = 1e-4, 1e-3
AUG = dict(scales=(48, 56), max_size=80, canvas_short=48, canvas_long=64, hflip=True,
           scale_hflip=False, detections_per_img=10)


class Counting:
    """A model whose detector calls are counted (either package's)."""

    def __init__(self, model):
        self.model, self.calls = model, 0

    def apply(self, *a, **k):  # JAX
        self.calls += 1
        return self.model.apply(*a, **k)

    def forward_test(self, *a):  # the port
        self.calls += 1
        return self.model.forward_test(*a)

    def parameters(self):
        return self.model.parameters()


def _base_models(tiny_root):
    model = JaxRCNN(c=TINY_C)
    ds = JaxVIDDataset(**dataset_args(tiny_root), is_train=False)
    inputs, gt = assemble_inputs("base", JaxEvalPreprocessor(**_prep_kwargs())(ds[0]))
    params = jit_init(model, jax.random.PRNGKey(0), inputs, gt, jax.random.PRNGKey(1),
                      train=True)["params"]
    params = _perturb(to_np(params), np.random.RandomState(1))
    port = port_model_from(GeneralizedRCNN, params, port_configs(TINY_C)[0])
    return model, params, port, ds


def _assert_same_detections(got, want):
    assert len(got["boxes"]) == len(want["boxes"]) > 0
    go, wo = np.argsort(-got["scores"], kind="stable"), np.argsort(-want["scores"],
                                                                   kind="stable")
    np.testing.assert_array_equal(got["labels"][go], np.asarray(want["labels"])[wo])
    np.testing.assert_allclose(got["scores"][go], want["scores"][wo], rtol=0, atol=ATOL_SCORE)
    np.testing.assert_allclose(got["boxes"][go], want["boxes"][wo], rtol=0, atol=ATOL_BOX)


@pytest.mark.parametrize("idx", [0, 7])
def test_im_detect_bbox_aug_matches_jax(tiny_root, idx):
    model, params, port, ds = _base_models(tiny_root)
    pil = ds.load_image(idx)
    jax_model, port_model = Counting(model), Counting(port)
    want = jax_bbox_aug(jax_model, params, pil, **AUG)
    got = im_detect_bbox_aug(port_model, np.asarray(pil), **AUG)
    # base scale plain + base flip + extra scale plain (no SCALE_H_FLIP)
    assert jax_model.calls == port_model.calls == 3
    assert got["boxes"].shape[1] == 4 and len(got["boxes"]) <= 10
    w0, h0 = pil.size
    assert got["boxes"][:, [0, 2]].max() <= w0 + 1 and got["boxes"][:, [1, 3]].max() <= h0 + 1
    _assert_same_detections(got, want)


def _tta_opts():
    return TINY_OPTS + ["TEST.BBOX_AUG.ENABLED", "True", "TEST.BBOX_AUG.H_FLIP", "True",
                        "TEST.BBOX_AUG.SCALE_H_FLIP", "True", "TEST.BBOX_AUG.SCALES", "(56,)",
                        "TEST.BBOX_AUG.MAX_SIZE", "80", "TEST.DETECTIONS_PER_IMG", "8"]


def test_test_net_bbox_aug_equals_direct_calls(tiny_root, tmp_path):
    """``test_net.main`` with TEST.BBOX_AUG on the base preset: each frame's
    prediction equals ``im_detect_bbox_aug`` called directly on the seeded
    model (4 runs a frame: both scales, each flipped), and evaluation runs."""
    data_dir = ilsvrc_data_dir(tiny_root, tmp_path)
    out = tmp_path / "out"
    run = test_net.main(["--preset", "base_R_50", "--data-dir", str(data_dir),
                         "--output-dir", str(out), "--seed", "3", "--device", "cpu",
                         "opts", *_tta_opts()])
    cfg = get_preset("base_R_50")
    cfg.merge_from_list(_tta_opts())
    model = Counting(build_detection_model(cfg, "cpu", torch.Generator("cpu").manual_seed(3)))
    ds = port_dataset(tiny_root, "VIDDataset")
    assert sorted(run["predictions"]) == list(range(len(ds)))
    for i in range(len(ds)):
        want = im_detect_bbox_aug(model, ds.load_image(i), scales=(48, 56), max_size=80,
                                  canvas_short=48, canvas_long=64, hflip=True,
                                  scale_hflip=True, nms_thresh=cfg.MODEL.ROI_HEADS.NMS,
                                  detections_per_img=8)
        for k in ("boxes", "scores", "labels"):
            np.testing.assert_array_equal(run["predictions"][i][k], want[k], err_msg=f"{i} {k}")
        assert len(want["boxes"]) <= 8
    assert model.calls == 4 * len(ds)
    assert np.isfinite(run["result"]["all"]["map"])
    assert (out / "predictions_0.npz").exists()


def test_test_net_bbox_aug_refuses_video_methods(tiny_root, tmp_path):
    data_dir = ilsvrc_data_dir(tiny_root, tmp_path)
    with pytest.raises(ValueError, match="single-frame only"):
        test_net.main(["--preset", "mega_R_50", "--data-dir", str(data_dir), "--output-dir",
                       str(tmp_path / "out"), "--device", "cpu", "opts", *_tta_opts()])
