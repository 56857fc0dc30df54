"""The detector zoo's models in the port against the JAX package, float32 on
the CPU, weights bridged from flax: the R-*-FPN body on RGB, s2d(2)- and
s2d(4)-packed frames, FPN with each top block, RetinaNet's head, anchors,
loss and inference, the mask and keypoint heads, ``CombinedROIHeads``, the
segmentation structures and every FBNet arch with its head groups. Each
bridged module's parameter names and shapes equal the port's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_pytorch_tpu.config import get_default_cfg as jax_default_cfg
from mega_pytorch_tpu.models.backbone import fbnet as jax_fbnet
from mega_pytorch_tpu.models.backbone import fpn as jax_fpn
from mega_pytorch_tpu.models.roi_heads import combined as jax_combined
from mega_pytorch_tpu.models.roi_heads import mask_head as jax_mask
from mega_pytorch_tpu.models.roi_heads.subsample import SampledRois as JaxSampledRois
from mega_pytorch_tpu.models.rpn import retinanet as jax_retina
from mega_pytorch_tpu.structures import segmentation as jax_seg
from mega_pytorch_tpu.utils.misc import jit_init
from mega_pytorch_tpu_torch.config import get_default_cfg
from mega_pytorch_tpu_torch.data.transforms import s2d_pack_frames
from mega_pytorch_tpu_torch.models.backbone import fbnet, fpn
from mega_pytorch_tpu_torch.models.layers import init_module_
from mega_pytorch_tpu_torch.models.roi_heads import combined, mask_head
from mega_pytorch_tpu_torch.models.roi_heads.subsample import SampledRois
from mega_pytorch_tpu_torch.models.rpn import retinanet
from mega_pytorch_tpu_torch.structures import segmentation
from mega_pytorch_tpu_torch.utils.bridge import state_dict_from_flax
from torch_port_harness import _perturb, to_np

torch.set_num_threads(2)

# f32 convolutions summed in another order by XLA and PyTorch, through a few
# layers: 1e-4 of the largest magnitude
REL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rel=REL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _init(module, *args, **kw):
    return to_np(jit_init(module, jax.random.PRNGKey(0), *args, **kw)["params"])


def _random_params(module, *args):
    """A parameter tree of ``module``'s shapes (traced, not compiled) with
    random values: kernels at 1/sqrt(fan-in), norm scales about 1, biases
    about 0 (flax's own init compiles the whole network, 5-10 s an FBNet on
    the CPU)."""
    rs = np.random.RandomState(len(jax.tree_util.tree_leaves(args)))
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))["params"]

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return (rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + rs.randn(*shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _apply(module, params, *args):
    return jax.jit(lambda p, *a: module.apply({"params": p}, *a))(params, *args)


def _load(port, params):
    """Bridge ``params`` into ``port``: the names and shapes must be the
    port's own, then a strict load; eval mode, no gradients."""
    sd = state_dict_from_flax(params)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in port.state_dict().items()}
    port.load_state_dict(sd, strict=True)
    return port.eval().requires_grad_(False)


# -- FPN ------------------------------------------------------------------------

@pytest.mark.parametrize("factor", [1, 2, 4])
def test_fpn_body_matches_jax(factor):
    """R-14 FPN body (res2 64 wide) on RGB, s2d(2)- and s2d(4)-packed frames:
    C2..C5 within 1e-4 of the largest magnitude."""
    rs = np.random.RandomState(factor)
    x3 = (rs.randn(2, 64, 96, 3) * 50).astype(np.float32)
    x = x3 if factor == 1 else s2d_pack_frames(x3, factor)
    body = jax_fpn.ResNetFPNBody(depth="R-14", res2_out_channels=64)
    params = _perturb(_init(body, jnp.asarray(x3)), rs)
    want = body.apply({"params": params}, jnp.asarray(x))
    port = _load(fpn.ResNetFPNBody("R-14", res2_out_channels=64), params)
    with torch.no_grad():
        got = port(_t(x))
    assert port.out_channels == [64, 128, 256, 512]
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("top_block,from_c5,leading_none", [
    ("maxpool", True, False), ("none", True, False), ("p6p7", True, True),
    ("p6p7", False, True), ("p6p7", True, False), ("maxpool", True, True)])
def test_fpn_matches_jax(top_block, from_c5, leading_none):
    rs = np.random.RandomState(5)
    widths = (8, 16, 32, 48)
    feats = [(rs.randn(1, 32 // 2 ** i, 48 // 2 ** i, c) * 3).astype(np.float32)
             for i, c in enumerate(widths)]
    jax_in = [jnp.asarray(f) for f in feats]
    port_in = [_t(f) for f in feats]
    in_channels = widths
    if leading_none:
        jax_in[0] = port_in[0] = None
        in_channels = (None, *widths[1:])
    m = jax_fpn.FPN(out_channels=16, top_block=top_block, p6p7_in_from_c5=from_c5)
    params = _init(m, jax_in)
    want = m.apply({"params": params}, jax_in)
    port = _load(fpn.FPN(16, top_block, from_c5, in_channels), params)
    with torch.no_grad():
        got = port(port_in)
    assert len(got) == len(want) == {"maxpool": 1, "none": 0, "p6p7": 2}[top_block] + (
        3 if leading_none else 4)
    for g, w in zip(got, want):
        _close(g, w)


# -- RetinaNet --------------------------------------------------------------------

SHAPES = [(8, 12), (4, 6), (2, 3)]


def _retina_head(rs):
    feats = [(rs.randn(2, h, w, 16)).astype(np.float32) for h, w in SHAPES]
    head = jax_retina.RetinaNetHead(num_classes=5, num_anchors=9, num_convs=2, channels=16)
    params = _init(head, [jnp.asarray(f) for f in feats])
    port = _load(retinanet.RetinaNetHead(16, num_classes=5, num_anchors=9, num_convs=2,
                                         channels=16), params)
    return head, params, port, feats


def test_retinanet_head_and_anchors_match_jax():
    rs = np.random.RandomState(6)
    head, params, port, feats = _retina_head(rs)
    want_l, want_b = head.apply({"params": params}, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got_l, got_b = port([_t(f) for f in feats])
    for g, w in zip(got_l + got_b, want_l + want_b):
        _close(g, w)
    # the prior-probability bias, as flax's constant initialiser sets it
    fresh = init_module_(retinanet.RetinaNetHead(16, num_classes=5, num_convs=2, channels=16),
                         torch.Generator().manual_seed(0))
    np.testing.assert_allclose(fresh.cls_logits.bias.detach().numpy(),
                               np.asarray(params["cls_logits"]["bias"]), rtol=1e-7)
    sizes, strides = (32, 64, 128), (8, 16, 32)
    want_a = jax_retina.retinanet_anchors(SHAPES, sizes, strides)
    got_a = retinanet.retinanet_anchors(SHAPES, sizes, strides)
    for g, w in zip(got_a, want_a):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_retinanet_loss_matches_jax():
    rs = np.random.RandomState(7)
    anchors = np.concatenate([np.asarray(a) for a in jax_retina.retinanet_anchors(
        SHAPES, (32, 64, 128), (8, 16, 32))])
    n = len(anchors)
    logits = (rs.randn(n, 5) * 2).astype(np.float32)
    bbox = (rs.randn(n, 4) * 0.5).astype(np.float32)
    gt = np.array([[5.0, 5.0, 40.0, 40.0], [30.0, 10.0, 90.0, 60.0], [0, 0, 0, 0]],
                  np.float32)
    labels = np.array([2, 5, 0], np.int32)
    valid = np.array([True, True, False])
    want = jax_retina.retinanet_loss(*map(jnp.asarray, (anchors, logits, bbox, gt, labels,
                                                        valid)))
    got = retinanet.retinanet_loss(_t(anchors), _t(logits), _t(bbox), _t(gt),
                                   _t(labels).long(), _t(valid))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5)


def test_retinanet_inference_matches_jax():
    """Keep sets and labels equal, boxes and scores within 1e-4. Logits on a
    grid of 0.5 plant many equal scores, so the top-k and NMS tie orders
    show."""
    rs = np.random.RandomState(8)
    anchors = [np.asarray(a) for a in jax_retina.retinanet_anchors(
        SHAPES, (32, 64, 128), (8, 16, 32))]
    logits = [(np.round(rs.randn(len(a), 5) * 4) / 2).astype(np.float32) for a in anchors]
    deltas = [(rs.randn(len(a), 4) * 0.3).astype(np.float32) for a in anchors]
    assert len(np.unique(np.concatenate(logits))) < 40  # ties everywhere
    for top_n, dets in ((50, 20), (1000, 100)):
        want = jax_retina.retinanet_inference(
            [jnp.asarray(a) for a in anchors], [jnp.asarray(x) for x in logits],
            [jnp.asarray(d) for d in deltas], (60.0, 90.0), pre_nms_top_n=top_n,
            detections_per_img=dets)
        got = retinanet.retinanet_inference(
            [_t(a) for a in anchors], [_t(x) for x in logits], [_t(d) for d in deltas],
            (60.0, 90.0), pre_nms_top_n=top_n, detections_per_img=dets)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        assert got[3].sum() > 5
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-4)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-4)


# -- mask and keypoint heads ----------------------------------------------------------

ROIS = np.array([[[4.0, 6.0, 50.0, 40.0], [0.0, 0.0, 20.0, 30.0], [30.0, 10.0, 63.0, 47.0]],
                 [[10.0, 10.0, 40.0, 30.0], [2.0, 20.0, 60.0, 45.0], [0.0, 0.0, 63.0, 47.0]]],
                np.float32)


def test_mask_head_matches_jax():
    rs = np.random.RandomState(9)
    feat = rs.randn(2, 12, 16, 8).astype(np.float32)
    ext = jax_mask.MaskRCNNFPNFeatureExtractor(resolution=6, spatial_scale=0.25,
                                               layers=(16, 16))
    pe = _init(ext, jnp.asarray(feat), jnp.asarray(ROIS))
    x = ext.apply({"params": pe}, jnp.asarray(feat), jnp.asarray(ROIS))
    pred = jax_mask.MaskRCNNC4Predictor(num_classes=5, dim_reduced=8)
    pp = _init(pred, x)
    pp["conv5_mask"]["bias"] = rs.randn(8).astype(np.float32) * 0.1
    logits = pred.apply({"params": pp}, x)
    port_ext = _load(mask_head.MaskRCNNFPNFeatureExtractor(8, 6, 0.25, layers=(16, 16)), pe)
    port_pred = _load(mask_head.MaskRCNNC4Predictor(16, 5, 8), pp)
    with torch.no_grad():
        gx = port_ext(_t(feat), _t(ROIS))
        glogits = port_pred(gx)
    _close(gx, x)
    _close(glogits, logits)
    assert glogits.shape == (2, 3, 12, 12, 5)

    labels = np.array([[1, 3, 0], [4, 2, 2]], np.int32)
    valid = np.array([[True, True, False], [True, False, True]])
    targets = (rs.rand(2, 3, 12, 12) > 0.5).astype(np.float32)
    want = jax_mask.maskrcnn_loss(logits, jnp.asarray(targets), jnp.asarray(labels),
                                  jnp.asarray(valid))
    got = mask_head.maskrcnn_loss(_t(np.asarray(logits)), _t(targets), _t(labels), _t(valid))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    _close(mask_head.maskrcnn_inference(_t(np.asarray(logits)), _t(labels)),
           jax_mask.maskrcnn_inference(logits, jnp.asarray(labels)), 1e-6)


def test_keypoint_head_matches_jax():
    rs = np.random.RandomState(10)
    feat = rs.randn(2, 12, 16, 8).astype(np.float32)
    ext = jax_mask.KeypointRCNNFeatureExtractor(resolution=5, spatial_scale=0.25,
                                                layers=(16, 16, 16))
    pe = _init(ext, jnp.asarray(feat), jnp.asarray(ROIS))
    x = ext.apply({"params": pe}, jnp.asarray(feat), jnp.asarray(ROIS))
    pred = jax_mask.KeypointRCNNPredictor(num_keypoints=4)
    pp = _init(pred, x)
    heat = pred.apply({"params": pp}, x)
    port_ext = _load(mask_head.KeypointRCNNFeatureExtractor(8, 5, 0.25, layers=(16,) * 3), pe)
    port_pred = _load(mask_head.KeypointRCNNPredictor(16, 4), pp)
    with torch.no_grad():
        gheat = port_pred(port_ext(_t(feat), _t(ROIS)))
    assert gheat.shape == (2, 3, 20, 20, 4)
    _close(gheat, heat)

    # loss and inference on heatmaps with planted equal maxima (first wins)
    s = 20
    kp = (np.round(rs.randn(2, 3, s, s, 4) * 2) / 2).astype(np.float32)
    targets = rs.randint(0, s * s, size=(2, 3, 4)).astype(np.int32)
    vis = rs.rand(2, 3, 4) > 0.3
    want = jax_mask.keypointrcnn_loss(jnp.asarray(kp), jnp.asarray(targets), jnp.asarray(vis))
    got = mask_head.keypointrcnn_loss(_t(kp), _t(targets), _t(vis))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    want_xy, want_s = jax_mask.keypointrcnn_inference(jnp.asarray(kp), jnp.asarray(ROIS))
    got_xy, got_s = mask_head.keypointrcnn_inference(_t(kp), _t(ROIS))
    np.testing.assert_allclose(got_xy.numpy(), np.asarray(want_xy), rtol=1e-6)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_combined_roi_heads_match_jax():
    rs = np.random.RandomState(11)
    feat = rs.randn(2, 12, 16, 8).astype(np.float32)
    gt_masks = np.zeros((2, 3, 48, 64), np.float32)
    gt_masks[0, 0, 6:30, 8:40] = 1
    gt_masks[0, 1, 20:48, 30:64] = 1
    gt_masks[1, 0, 10:30, 10:40] = 1
    gt_masks[1, 2] = rs.rand(48, 64) > 0.5
    matched = np.array([[0, 1, 2], [0, 2, 1]], np.int32)
    labels = np.array([[3, 1, 0], [2, 4, 1]], np.int32)
    valid = np.array([[True, True, True], [True, True, False]])
    jrois = JaxSampledRois(jnp.asarray(ROIS), jnp.asarray(valid), jnp.asarray(labels),
                           jnp.zeros((2, 3, 4)))
    heads = jax_combined.CombinedROIHeads(mask_on=True, keypoint_on=True, num_classes=5,
                                          num_keypoints=4, spatial_scale=0.25)

    def both(m, feat, rois, masks, matched):
        return m.mask_losses(feat, rois, masks, matched), m.keypoint_logits(feat, rois.boxes)

    params = _init(heads, jnp.asarray(feat), jrois, jnp.asarray(gt_masks),
                   jnp.asarray(matched), method=both)
    port = _load(combined.CombinedROIHeads(8, True, True, 5, 4, spatial_scale=0.25), params)
    prois = SampledRois(_t(ROIS), _t(valid), _t(labels).long(), torch.zeros(2, 3, 4))
    want_loss, want_kp = heads.apply({"params": params}, jnp.asarray(feat), jrois,
                                     jnp.asarray(gt_masks), jnp.asarray(matched), method=both)
    want_probs = heads.apply({"params": params}, jnp.asarray(feat), jnp.asarray(ROIS),
                             jnp.asarray(labels), method=heads.mask_probs)
    with torch.no_grad():
        got_loss = port.mask_losses(_t(feat), prois, _t(gt_masks), _t(matched))
        got_kp = port.keypoint_logits(_t(feat), _t(ROIS))
        got_probs = port.mask_probs(_t(feat), _t(ROIS), _t(labels))
    np.testing.assert_allclose(got_loss["loss_mask"].item(), float(want_loss["loss_mask"]),
                               rtol=1e-4)
    _close(got_kp, want_kp)
    _close(got_probs, want_probs)

    for i in range(2):  # the targets, exactly
        want_t = jax_combined.mask_targets_from_dense(
            jnp.asarray(gt_masks[i]), jnp.asarray(matched[i]), jnp.asarray(ROIS[i]), 28)
        got_t = combined.mask_targets_from_dense(_t(gt_masks[i]), _t(matched[i]),
                                                 _t(ROIS[i]), 28)
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


# -- segmentation structures ---------------------------------------------------------

POLYS = [[[5, 5, 25, 4, 30, 22, 8, 28]], [[40.5, 10, 60, 12, 55.5, 40, 42, 33],
                                           [10, 30, 20, 30, 15, 38]]]


def test_segmentation_structures_match_jax():
    size = (64, 48)
    jm, pm = jax_seg.SegmentationMask(POLYS, size), segmentation.SegmentationMask(POLYS, size)
    boxes = np.array([[4.0, 3.0, 31.0, 29.0], [9.0, 9.0, 61.0, 41.0]])
    for op in (lambda m: m.transpose(jax_seg.FLIP_LEFT_RIGHT),
               lambda m: m.transpose(jax_seg.FLIP_TOP_BOTTOM),
               lambda m: m.crop([3.0, 2.0, 50.0, 40.0]),
               lambda m: m.resize((100, 75)),
               lambda m: m[[1]]):
        a, b = op(jm), op(pm)
        assert a.size == b.size and len(a) == len(b)
        for ia, ib in zip(a.instances, b.instances):
            for pa, pb in zip(ia.polygons, ib.polygons):
                np.testing.assert_array_equal(pa, pb)
            np.testing.assert_array_equal(ia.rasterize(), ib.rasterize())
    np.testing.assert_array_equal(pm.to_mask_targets(boxes, 28),
                                  jm.to_mask_targets(boxes, 28))
    kp = np.array([[[10.0, 20.0, 2.0], [3.0, 4.0, 1.0]]])
    ja, pa = jax_seg.Keypoints(kp, size), segmentation.Keypoints(kp, size)
    np.testing.assert_array_equal(pa.resize((80, 60)).keypoints,
                                  ja.resize((80, 60)).keypoints)
    np.testing.assert_array_equal(pa.transpose(0).keypoints, ja.transpose(0).keypoints)


# -- FBNet ------------------------------------------------------------------------------

ARCHS = ["default", "xirb16d_dsmask", "mobilenet_v2", "cham_v1a", "cham_v2"]


def test_fbnet_arch_tables_equal_jax():
    for name in ARCHS:
        assert fbnet.MODEL_ARCH[name] == jax_fbnet.MODEL_ARCH[name]
    # every arch of the JAX package's zoo (other tests may register more)
    assert set(fbnet.MODEL_ARCH) == set(ARCHS)
    assert set(ARCHS) <= set(jax_fbnet.MODEL_ARCH)
    for c, s, d in ((96, 0.5, 1), (88, 0.25, 8), (24, 0.3, 4)):
        assert fbnet._scale_channels(c, s, d) == jax_fbnet._scale_channels(c, s, d)


@pytest.mark.parametrize("arch", ARCHS)
def test_fbnet_trunk_and_heads_match_jax(arch):
    """The trunk and each head group of the arch at width 0.5 on a 64x64
    image, within 1e-4 of the largest magnitude."""
    rs = np.random.RandomState(12)
    x = jnp.asarray(rs.randn(1, 64, 64, 3).astype(np.float32))
    trunk = jax_fbnet.FBNetTrunk(arch=arch, width_scale=0.5)
    params = _random_params(trunk, x)
    y = _apply(trunk, params, x)
    port = _load(fbnet.FBNetTrunk(arch, 0.5), params)
    with torch.no_grad():
        got = port(_t(x))
    assert port.out_channels == trunk.out_channels
    _close(got, y)
    for group in ("rpn", "bbox", "mask"):
        if group not in jax_fbnet.MODEL_ARCH[arch]:
            continue
        head = jax_fbnet.FBNetTrunk(arch=arch, width_scale=0.5, stage_group=group,
                                    in_channels=trunk.out_channels)
        hp = _random_params(head, y)
        ph = _load(fbnet.FBNetTrunk(arch, 0.5, stage_group=group,
                                    in_channels=trunk.out_channels), hp)
        with torch.no_grad():
            _close(ph(_t(y)), _apply(head, hp, y))


def test_fbnet_builders_from_config_match_jax():
    """``build_fbnet_backbone`` / ``build_fbnet_head`` from the config (f32
    compute), weights from flax's own initialisers."""
    opts = ["MODEL.FBNET.ARCH", "xirb16d_dsmask", "MODEL.FBNET.SCALE_FACTOR", "0.25",
            "MODEL.FBNET.WIDTH_DIVISOR", "8", "TPU.COMPUTE_DTYPE", "float32"]
    jcfg, pcfg = jax_default_cfg(), get_default_cfg()
    jcfg.merge_from_list(opts)
    pcfg.merge_from_list(opts)
    rs = np.random.RandomState(13)
    x = jnp.asarray(rs.randn(1, 48, 64, 3).astype(np.float32))
    trunk = jax_fbnet.build_fbnet_backbone(jcfg)
    params = _init(trunk, x)
    y = _apply(trunk, params, x)
    port = _load(fbnet.build_fbnet_backbone(pcfg), params)
    with torch.no_grad():
        _close(port(_t(x)), y)
    head = jax_fbnet.build_fbnet_head(jcfg, "mask", trunk.out_channels)
    hp = _random_params(head, y)
    ph = _load(fbnet.build_fbnet_head(pcfg, "mask", port.out_channels), hp)
    with torch.no_grad():
        got = ph(_t(y))
    assert got.shape[1] > y.shape[1]  # the mask group's negative strides upsample
    _close(got, _apply(head, hp, y))
