"""Each ported module against its JAX counterpart on the same inputs and
(bridged) weights, float32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_pytorch_tpu.data.transforms import normalize_u8_frames as jax_normalize
from mega_pytorch_tpu.data.transforms import s2d_pack_frames as jax_pack
from mega_pytorch_tpu.models.backbone.resnet import ResNetC4 as JaxResNetC4
from mega_pytorch_tpu.models.backbone.resnet import ResNetRes5Head as JaxRes5
from mega_pytorch_tpu.models.backbone.resnet import Stem as JaxStem
from mega_pytorch_tpu.models.roi_heads.attention import (
    RelationAttention as JaxRelationAttention,
)
from mega_pytorch_tpu.models.roi_heads.inference import (
    postprocess_detections as jax_postprocess,
)
from mega_pytorch_tpu.models.rpn import rpn as jax_rpn
from mega_pytorch_tpu.models.rpn.anchors import generate_cell_anchors, grid_anchors
from mega_pytorch_tpu.ops.box_coder import BoxCoder as JaxBoxCoder
from mega_pytorch_tpu.ops.nms import nms as jax_nms
from mega_pytorch_tpu.ops.roi_align import roi_align as jax_roi_align
from mega_pytorch_tpu.structures import boxes as jax_boxes
from mega_pytorch_tpu_torch.data.transforms import normalize_u8_frames, s2d_pack_frames
from mega_pytorch_tpu_torch.models.backbone.resnet import ResNetC4, ResNetRes5Head, Stem
from mega_pytorch_tpu_torch.models.roi_heads.attention import RelationAttention
from mega_pytorch_tpu_torch.models.roi_heads.inference import postprocess_detections
from mega_pytorch_tpu_torch.models.rpn import anchors as port_anchors
from mega_pytorch_tpu_torch.models.rpn import rpn as port_rpn
from mega_pytorch_tpu_torch.ops.box_coder import BoxCoder
from mega_pytorch_tpu_torch.ops.nms import nms
from mega_pytorch_tpu_torch.ops.roi_align import roi_align
from mega_pytorch_tpu_torch.structures import boxes as port_boxes
from mega_pytorch_tpu_torch.utils.bridge import state_dict_from_flax
from torch_port_harness import _perturb, to_np

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _load(module, params):
    module.load_state_dict(state_dict_from_flax(params), strict=True)
    return module.eval().requires_grad_(False)


# -- host feed ------------------------------------------------------------------

@pytest.mark.parametrize("factor", [1, 4])
def test_normalize_u8_frames_exact(factor):
    rs = np.random.RandomState(0)
    frames = rs.randint(0, 256, (2, 32, 48, 3), dtype=np.uint8)
    sizes = np.array([[32, 48], [27, 41]], np.float32)
    if factor > 1:
        np.testing.assert_array_equal(s2d_pack_frames(frames, factor),
                                      jax_pack(frames, factor))
        frames = s2d_pack_frames(frames, factor)
    want = np.asarray(jax_normalize(jnp.asarray(frames), jnp.asarray(sizes)))
    got = normalize_u8_frames(_t(frames), _t(sizes)).numpy()
    np.testing.assert_array_equal(got, want)


def test_anchors_and_decode():
    cell = port_anchors.generate_cell_anchors(16, (64, 128, 256, 512))
    np.testing.assert_array_equal(cell, generate_cell_anchors(16, (64, 128, 256, 512)))
    np.testing.assert_array_equal(port_anchors.grid_anchors(5, 7, 16, cell),
                                  np.asarray(grid_anchors(5, 7, 16, cell)))
    rs = np.random.RandomState(1)
    deltas = (rs.randn(50, 4 * 3) * 2).astype(np.float32)
    deltas[0, 2] = 20.0  # beyond the log(1000/16) clip
    boxes = np.abs(rs.randn(50, 4) * 40).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    w = (10.0, 10.0, 5.0, 5.0)
    want = np.asarray(JaxBoxCoder(w).decode(jnp.asarray(deltas), jnp.asarray(boxes)))
    got = BoxCoder(w).decode(_t(deltas), _t(boxes)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def test_box_geometry_matches():
    rs = np.random.RandomState(11)
    a = np.abs(rs.randn(9, 4) * 30).astype(np.float32)
    a[:, 2:] += a[:, :2]
    b = np.abs(rs.randn(7, 4) * 30).astype(np.float32)
    b[:, 2:] += b[:, :2] - 5  # some degenerate boxes
    np.testing.assert_array_equal(port_boxes.area(_t(a)).numpy(),
                                  np.asarray(jax_boxes.area(jnp.asarray(a))))
    np.testing.assert_allclose(port_boxes.box_iou(_t(a), _t(b)).numpy(),
                               np.asarray(jax_boxes.box_iou(jnp.asarray(a),
                                                            jnp.asarray(b))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        port_boxes.clip_to_image(_t(a) - 10, 40.0, 50.0).numpy(),
        np.asarray(jax_boxes.clip_to_image(jnp.asarray(a) - 10, 40.0, 50.0)))
    np.testing.assert_array_equal(
        port_boxes.small_box_mask(_t(b), 8.0).numpy(),
        np.asarray(jax_boxes.small_box_mask(jnp.asarray(b), 8.0)))


# -- backbone ---------------------------------------------------------------------

def test_stem_canonical_and_packed_paths_match():
    """The canonical 3-channel stem against JAX's, and the port's s2d(4)
    packed path (3x3 reformulation + stem pool) against its canonical one."""
    rs = np.random.RandomState(12)
    x3 = (rs.randn(2, 48, 64, 3) * 50).astype(np.float32)
    stem = JaxStem()
    params = _perturb(to_np(jax.jit(stem.init)(jax.random.PRNGKey(2), jnp.asarray(x3))
                            ["params"]), rs)
    want = np.asarray(stem.apply({"params": params}, jnp.asarray(x3)))
    port = _load(Stem(), params)
    with torch.inference_mode():
        got3 = port(_t(x3)).permute(0, 2, 3, 1).numpy()
        got48 = port(_t(s2d_pack_frames(x3, 4))).permute(0, 2, 3, 1).numpy()
    assert got3.shape == got48.shape == (2, 12, 16, 64)
    np.testing.assert_allclose(got3, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got48, got3, rtol=1e-4, atol=1e-4)


def test_resnet_c4_and_res5_head_match():
    rs = np.random.RandomState(2)
    x = (rs.randn(2, 16, 24, 48) * 50).astype(np.float32)  # s2d(4)-packed input
    body = JaxResNetC4(depth="R-14")
    params = _perturb(to_np(jax.jit(body.init)(jax.random.PRNGKey(0), jnp.asarray(x))
                            ["params"]), rs)
    want = np.asarray(body.apply({"params": params}, jnp.asarray(x)))
    port = _load(ResNetC4("R-14"), params)
    with torch.inference_mode():
        got = port(_t(x)).numpy()
    assert got.shape == want.shape == (2, 4, 6, 1024)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    c4 = rs.randn(2, 4, 6, 1024).astype(np.float32)
    head = JaxRes5(depth="R-14", stride_init=1, dilation=2)
    hp = _perturb(to_np(jax.jit(head.init)(jax.random.PRNGKey(1), jnp.asarray(c4))
                        ["params"]), rs)
    want = np.asarray(head.apply({"params": hp}, jnp.asarray(c4)))
    port_head = _load(ResNetRes5Head("R-14", 1, 2), hp)
    with torch.inference_mode():
        got = port_head(_t(c4)).numpy()
    assert got.shape == (2, 4, 6, 2048)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# -- RPN and NMS ------------------------------------------------------------------

def _rpn_inputs(seed):
    rs = np.random.RandomState(seed)
    anchors = grid_anchors(16, 16, 16, generate_cell_anchors(16, (32, 64, 128)))
    n = anchors.shape[0]  # 2304
    obj = (rs.randn(2, n) * 3).astype(np.float32)
    obj[0, 100:140] = obj[0, 5]  # exact score ties
    deltas = (rs.randn(2, n, 4) * 0.3).astype(np.float32)
    sizes = np.array([[250.0, 240.0], [256.0, 200.0]], np.float32)
    return obj, deltas, np.asarray(anchors), sizes


@pytest.mark.parametrize("size_deltas", [False, True])
@pytest.mark.parametrize("post", [300, 40])
def test_rpn_postprocess_keeps_exact(post, size_deltas):
    """pre-NMS 2000 > max(chunk, 2*post): the chunked NMS path. Keep sets are
    exact. Kept boxes are bit-exact while the size deltas are 0; with size
    deltas, exp() (XLA's and PyTorch's differ by an ulp) moves them by ulps."""
    obj, deltas, anchors, sizes = _rpn_inputs(3)
    if not size_deltas:
        deltas[..., 2:] = 0.0
    s = (2000, post, 0.7, 0.0)
    want = jax_rpn.rpn_postprocess(jnp.asarray(obj), jnp.asarray(deltas),
                                   jnp.asarray(anchors), jnp.asarray(sizes),
                                   jax_rpn.RPNSizes(*s))
    got = port_rpn.rpn_postprocess(_t(obj), _t(deltas), _t(anchors), _t(sizes),
                                   port_rpn.RPNSizes(*s))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.fields["objectness"].numpy(),
                                  np.asarray(want.fields["objectness"]))
    if size_deltas:
        np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                                   rtol=0, atol=1e-4)
    else:
        np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want.boxes))


def test_shared_ref_key_postprocess_prefix_and_fallback():
    obj, deltas, anchors, sizes = _rpn_inputs(4)
    deltas[..., 2:] = 0.0  # exp-free decode: boxes bit-exact
    key = (600, 60, 0.7, 0.0)
    for ref, prefix in (((600, 15, 0.7, 0.0), True), ((300, 15, 0.7, 0.0), False)):
        jr, jk, jp = jax_rpn.shared_ref_key_postprocess(
            jnp.asarray(obj), jnp.asarray(deltas), jnp.asarray(anchors),
            jnp.asarray(sizes), jax_rpn.RPNSizes(*ref), jax_rpn.RPNSizes(*key))
        pr, pk, pp = port_rpn.shared_ref_key_postprocess(
            _t(obj), _t(deltas), _t(anchors), _t(sizes), port_rpn.RPNSizes(*ref),
            port_rpn.RPNSizes(*key))
        assert pp == jp == prefix
        for w, g in ((jr, pr), (jk, pk)):
            np.testing.assert_array_equal(g.valid.numpy(), np.asarray(w.valid))
            np.testing.assert_array_equal(g.boxes.numpy(), np.asarray(w.boxes))


def _nms_inputs(seed, b, n):
    rs = np.random.RandomState(seed)
    xy = rs.rand(b, n, 2) * 100
    wh = 5 + rs.rand(b, n, 2) * 40
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = np.round(rs.rand(b, n), 2).astype(np.float32)  # many exact ties
    boxes[:, 1::7] = boxes[:, 0:1]  # duplicate boxes
    valid = rs.rand(b, n) > 0.1
    return boxes, scores, valid


@pytest.mark.parametrize("presorted", [False, True])
@pytest.mark.parametrize("n,max_out,chunk", [(120, 50, 1024), (300, 20, 64)])
def test_nms_keep_indices_exact(presorted, n, max_out, chunk):
    boxes, scores, valid = _nms_inputs(5, 3, n)
    if presorted:
        order = np.argsort(-scores, axis=1, kind="stable")
        take = lambda a: np.take_along_axis(  # noqa: E731
            a, order if a.ndim == 2 else order[..., None], 1)
        boxes, scores, valid = take(boxes), take(scores), take(valid)
    got_idx, got_valid, (got_boxes, got_scores) = nms(
        _t(boxes), _t(scores), _t(valid), 0.5, max_out, chunk=chunk,
        extras=(_t(scores),), return_boxes=True, presorted=presorted)
    for i in range(boxes.shape[0]):
        idx, kv, (kb, ks) = jax_nms(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), jnp.asarray(valid[i]),
            0.5, max_out, chunk=chunk, extras=(jnp.asarray(scores[i]),),
            return_boxes=True, presorted=presorted)
        np.testing.assert_array_equal(got_idx[i].numpy(), np.asarray(idx))
        np.testing.assert_array_equal(got_valid[i].numpy(), np.asarray(kv))
        np.testing.assert_array_equal(got_boxes[i].numpy(), np.asarray(kb))
        np.testing.assert_array_equal(got_scores[i].numpy(), np.asarray(ks))


def test_nms_pads_when_fewer_candidates_than_slots():
    boxes, scores, valid = _nms_inputs(6, 1, 5)
    idx, kv = nms(_t(boxes), _t(scores), _t(valid), 0.5, 8)
    jidx, jkv = jax_nms(jnp.asarray(boxes[0]), jnp.asarray(scores[0]),
                        jnp.asarray(valid[0]), 0.5, 8)
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(kv[0].numpy(), np.asarray(jkv))


# -- ROI path -------------------------------------------------------------------

def test_roi_align_matches():
    rs = np.random.RandomState(7)
    feat = rs.randn(12, 18, 32).astype(np.float32)
    rois = np.array([
        [0, 0, 100, 80], [10.5, 20.25, 40.75, 33.5], [250, 150, 290, 190],
        [-30, -20, 10, 5], [50, 50, 50.2, 50.1], [0, 0, 287, 191],
    ], np.float32)
    want = np.asarray(jax_roi_align(jnp.asarray(feat), jnp.asarray(rois), 1 / 16))
    got = roi_align(_t(feat)[None], _t(rois)[None], 1 / 16)[0].numpy()
    assert got.shape == (6, 7, 7, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("use_position", [False, True])
def test_relation_attention_matches(use_position):
    rs = np.random.RandomState(8)
    n, m = 23, 40
    x = rs.randn(n, 1024).astype(np.float32)
    refs = rs.randn(m, 1024).astype(np.float32)
    valid = rs.rand(m) > 0.3
    rois = (np.abs(rs.randn(n, 4)) * 50 + np.array([0, 0, 60, 60])).astype(np.float32)
    ref_rois = (np.abs(rs.randn(m, 4)) * 50 + np.array([0, 0, 60, 60])).astype(np.float32)
    jmod = JaxRelationAttention(use_position=use_position, use_u_bias=True)
    pos = (jnp.asarray(rois), jnp.asarray(ref_rois)) if use_position else None
    args = (jnp.asarray(x), jnp.asarray(refs), jnp.asarray(valid))
    params = to_np(jmod.init(jax.random.PRNGKey(0), *args, pos_rois=pos)["params"])
    params["Wv_kernel"] = params["Wv_kernel"] * 3  # values of order 1
    if use_position:
        # pw = relu(Wg . sinusoids + b) stays well above its relu corner, so
        # the bf16 rounding of the sinusoids (where torch's and XLA's log/sin
        # differ by an ulp, one bf16 step can flip) moves it by < 1e-4
        params["Wg"]["bias"] = np.full_like(params["Wg"]["bias"], 0.5)
    want = np.asarray(jmod.apply({"params": params}, *args, pos_rois=pos))
    port = _load(RelationAttention(use_position=use_position), params)
    with torch.inference_mode():
        got = port(_t(x)[None], _t(refs)[None], _t(valid)[None],
                   pos_rois=(_t(rois)[None], _t(ref_rois)[None]) if use_position
                   else None)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_postprocess_detections_matches():
    rs = np.random.RandomState(9)
    b, k, c = 2, 40, 31
    logits = (rs.randn(b, k, c) * 3).astype(np.float32)
    deltas = (rs.randn(b, k, 4 * c) * 0.5).astype(np.float32)
    # coordinates below 64 px keep an ulp of the decode's exp (which differs
    # between XLA and PyTorch) under the 1e-5 tolerance
    xy = rs.rand(b, k, 2) * 30
    props = np.concatenate([xy, xy + 4 + rs.rand(b, k, 2) * 25], -1).astype(np.float32)
    prop_valid = rs.rand(b, k) > 0.1
    sizes = np.array([[60.0, 63.0], [56.0, 62.0]], np.float32)
    kw = dict(score_thresh=0.05, nms_thresh=0.5, detections_per_img=50)
    want = jax_postprocess(*(jnp.asarray(a) for a in (logits, deltas, props,
                                                      prop_valid, sizes)), **kw)
    got = postprocess_detections(*(_t(a) for a in (logits, deltas, props,
                                                   prop_valid, sizes)), **kw)
    assert bool(got.valid.any())
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0,
                               atol=1e-5)


def test_postprocess_detections_batched_equals_per_image(monkeypatch):
    """One batched per-class NMS over all images keeps exactly what a call
    per image keeps (the images' rows never interact), and a batch pays its
    NMS (whose rounds each synchronise with the host) once, not per image."""
    rs = np.random.RandomState(10)
    b, k, c = 3, 60, 31
    logits = (rs.randn(b, k, c) * 3).astype(np.float32)
    deltas = (rs.randn(b, k, 4 * c) * 0.5).astype(np.float32)
    xy = rs.rand(b, k, 2) * 40
    props = np.concatenate([xy, xy + 4 + rs.rand(b, k, 2) * 30], -1).astype(np.float32)
    props[1, 10:20] = props[1, 0]  # duplicate boxes: suppression clusters
    prop_valid = rs.rand(b, k) > 0.1
    sizes = np.array([[60.0, 63.0], [56.0, 62.0], [48.0, 64.0]], np.float32)
    args = [_t(a) for a in (logits, deltas, props, prop_valid, sizes)]
    kw = dict(score_thresh=0.02, nms_thresh=0.5, detections_per_img=50)
    from mega_pytorch_tpu_torch.models.roi_heads import inference as port_inference

    calls = []
    monkeypatch.setattr(port_inference, "nms",
                        lambda *a, **k: calls.append(1) or nms(*a, **k))
    batched = postprocess_detections(*args, **kw)
    assert len(calls) == 1
    assert int(batched.valid.sum()) > 20
    for i in range(b):
        one = postprocess_detections(*(a[i:i + 1] for a in args), **kw)
        for name, got, want in zip(one._fields, batched, one):
            assert torch.equal(got[i:i + 1], want), (i, name)
