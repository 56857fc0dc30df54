"""The classic C4 box head (maskrcnn-benchmark's default ``ROI_BOX_HEAD``):
the port's ``ResNet50Conv5ROIFeatureExtractor`` and ``FastRCNNPredictor``
against the flax modules, weights bridged, f32 on the CPU: ROIAlign of
14x14 bins on one C4 map of 1024 channels, res5 with stride 2 on 8 ROIs,
the global average, the class and box layers. Each output within 1e-4 of
its largest magnitude (the same sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_pytorch_tpu.models.roi_heads import extractors as jax_extractors
from mega_pytorch_tpu.models.roi_heads import predictors as jax_predictors
from mega_pytorch_tpu_torch.models.roi_heads import extractors, predictors
from mega_pytorch_tpu_torch.utils.bridge import state_dict_from_flax
from torch_port_harness import _perturb, to_np

torch.set_num_threads(4)

RTOL = 1e-4
MAP_HW, NUM_ROIS = (16, 24), 8  # the C4 map of a 256x384 canvas


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("depth", ["R-50", "R-101"])
def test_classic_c4_head_matches_flax(depth):
    rs = np.random.RandomState(7)
    c4 = rs.randn(1, *MAP_HW, 1024).astype(np.float32)
    h, w = MAP_HW[0] * 16, MAP_HW[1] * 16
    xy = rs.uniform(0, [w - 40, h - 40], size=(1, NUM_ROIS, 2))
    wh = rs.uniform(8, 160, size=(1, NUM_ROIS, 2))
    rois = np.concatenate([xy, np.minimum(xy + wh, [w - 1, h - 1])], -1).astype(np.float32)

    ext = jax_extractors.ResNet50Conv5ROIFeatureExtractor(depth=depth)
    ep = jax.jit(ext.init)(jax.random.PRNGKey(0), jnp.asarray(c4), jnp.asarray(rois))["params"]
    ep = _perturb(to_np(ep), rs)  # FrozenBN statistics off identity
    feats = ext.apply({"params": ep}, jnp.asarray(c4), jnp.asarray(rois))
    pred = jax_predictors.FastRCNNPredictor()
    pp = to_np(jax.jit(pred.init)(jax.random.PRNGKey(1), feats)["params"])
    scores, deltas = pred.apply({"params": pp}, feats)

    port_ext = extractors.ResNet50Conv5ROIFeatureExtractor(depth)
    port_ext.load_state_dict(state_dict_from_flax(ep), strict=True)
    port_pred = predictors.FastRCNNPredictor()
    port_pred.load_state_dict(state_dict_from_flax(pp), strict=True)
    with torch.inference_mode():
        got = port_ext.eval()(torch.from_numpy(c4), torch.from_numpy(rois))
        got_scores, got_deltas = port_pred.eval()(got)
    assert got.shape == (1, NUM_ROIS, 7, 7, 2048) and port_ext.out_channels == 2048
    _close(got.numpy(), feats)
    _close(got_scores.numpy(), scores)
    _close(got_deltas.numpy(), deltas)
    assert got_deltas.shape == (1, NUM_ROIS, 4 * 31)
