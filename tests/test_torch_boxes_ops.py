"""Box helpers, the ``Boxes`` field API and the batch forms of NMS and
ROIAlign: the port against the JAX package's ``structures/boxes.py``,
``ops/nms.py:batched_nms`` and ``ops/roi_align.py:roi_align_batched``.
Box helpers are exact; NMS keep sets equal, with planted score ties;
batched ROIAlign within 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_pytorch_tpu.ops.nms import batched_nms as jax_batched_nms
from mega_pytorch_tpu.ops.roi_align import roi_align_batched as jax_roi_align_batched
from mega_pytorch_tpu.structures import boxes as jax_boxes
from mega_pytorch_tpu_torch.ops.nms import batched_nms
from mega_pytorch_tpu_torch.ops.roi_align import roi_align_batched
from mega_pytorch_tpu_torch.structures import boxes


def _boxes(rs, n, span=100.0):
    xy = rs.uniform(0, span, (n, 2))
    wh = rs.uniform(0, span / 2, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _sets(rs):
    """Two padded (N, 4) sets with scores and labels, as both packages hold them."""
    out = []
    for n in (5, 3):
        valid = rs.rand(n) > 0.3
        out.append((_boxes(rs, n), valid, rs.rand(n).astype(np.float32),
                    rs.randint(0, 31, n).astype(np.int32)))
    return out


def _jax_set(b, v, s, lab):
    return jax_boxes.Boxes(boxes=jnp.asarray(b), valid=jnp.asarray(v),
                           fields={"scores": jnp.asarray(s), "labels": jnp.asarray(lab)})


def _port_set(b, v, s, lab):
    return boxes.Boxes(torch.from_numpy(b), torch.from_numpy(v),
                       {"scores": torch.from_numpy(s), "labels": torch.from_numpy(lab)})


def _fields(x):
    """(boxes, valid, {field: array}) as numpy, from either package's Boxes."""
    return (np.asarray(x.boxes), np.asarray(x.valid),
            {k: np.asarray(v) for k, v in x.fields.items()})


def _case_hflip(rs):
    b = _boxes(rs, 7)
    return boxes.hflip_boxes(torch.from_numpy(b), 120), jax_boxes.hflip_boxes(jnp.asarray(b), 120)


def _case_resize(rs):
    b = _boxes(rs, 7)
    return (boxes.resize_boxes(torch.from_numpy(b), 0.75, 1.6),
            jax_boxes.resize_boxes(jnp.asarray(b), 0.75, 1.6))


def _case_xywh_to_xyxy(rs):
    b = _boxes(rs, 7)
    b[:, 2:] = rs.uniform(0, 3, (7, 2))  # widths below 1 clamp to a point
    return boxes.xywh_to_xyxy(torch.from_numpy(b)), jax_boxes.xywh_to_xyxy(jnp.asarray(b))


def _case_xyxy_to_xywh(rs):
    b = _boxes(rs, 7)
    return boxes.xyxy_to_xywh(torch.from_numpy(b)), jax_boxes.xyxy_to_xywh(jnp.asarray(b))


def _case_cat_boxes(rs):
    sets = _sets(rs)
    want = jax_boxes.cat_boxes([_jax_set(*s) for s in sets])
    got = boxes.cat_boxes([_port_set(*s) for s in sets])
    assert list(got.fields) == list(want.fields)
    return _fields(got), _fields(want)


def _case_cat_common_fields(rs):
    sets = _sets(rs)
    jax_list = [_jax_set(*s) for s in sets]
    port_list = [_port_set(*s) for s in sets]
    jax_list[1] = jax_list[1].replace(fields={"scores": jax_list[1].fields["scores"]})
    port_list[1] = port_list[1]._replace(fields={"scores": port_list[1].fields["scores"]})
    return _fields(boxes.cat_boxes(port_list)), _fields(jax_boxes.cat_boxes(jax_list))


def _case_fields_and_take(rs):
    (b, v, s, lab), _ = _sets(rs)
    idx = np.array([4, 0, 0, 2])
    idx_valid = np.array([True, True, False, True])
    jx = _jax_set(b, v, s, lab).add_field("objectness", jnp.arange(5.0))
    px = _port_set(b, v, s, lab).add_field("objectness", torch.arange(5.0))
    assert px.num_boxes == jx.num_boxes == 5
    assert px.has_field("objectness") and not px.has_field("masks")
    np.testing.assert_array_equal(px.get_field("labels").numpy(), jx.get_field("labels"))
    assert not _port_set(b, v, s, lab).has_field("objectness")  # add_field made a new set
    got = px.take(torch.from_numpy(idx), torch.from_numpy(idx_valid))
    want = jx.take(jnp.asarray(idx), jnp.asarray(idx_valid))
    return ((_fields(got), _fields(px.take(torch.from_numpy(idx)))),
            (_fields(want), _fields(jx.take(jnp.asarray(idx)))))


BOX_CASES = {f.__name__[len("_case_"):]: f for f in (
    _case_hflip, _case_resize, _case_xywh_to_xyxy, _case_xyxy_to_xywh, _case_cat_boxes,
    _case_cat_common_fields, _case_fields_and_take)}


def _assert_same(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_same(got[k], want[k])
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", BOX_CASES)
def test_box_helpers_equal_jax(case):
    _assert_same(*BOX_CASES[case](np.random.RandomState(11)))


@pytest.mark.parametrize("ties", [False, True])
def test_batched_nms_equals_jax(ties):
    """4 classes of 60 boxes; with ``ties`` every score is one of 5 levels,
    so most boxes tie with others of their class."""
    rs = np.random.RandomState(3)
    b = np.stack([_boxes(rs, 60) for _ in range(4)])
    s = rs.uniform(0, 1, (4, 60)).astype(np.float32)
    if ties:
        s = np.round(s * 4).astype(np.float32) / 4
    v = rs.rand(4, 60) > 0.1
    want_idx, want_valid = jax_batched_nms(jnp.asarray(b), jnp.asarray(s), jnp.asarray(v),
                                           0.5, 40)
    got_idx, got_valid = batched_nms(torch.from_numpy(b), torch.from_numpy(s),
                                     torch.from_numpy(v), 0.5, 40)
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))


@pytest.mark.parametrize("num_maps", [1, 3])
def test_roi_align_batched_equals_jax(num_maps):
    rs = np.random.RandomState(5)
    feats = rs.randn(num_maps, 12, 16, 8).astype(np.float32)
    rois = _boxes(rs, 10, span=180.0)
    batch_idx = rs.randint(0, num_maps, 10).astype(np.int32)
    want = jax_roi_align_batched(jnp.asarray(feats), jnp.asarray(rois), jnp.asarray(batch_idx),
                                 1 / 16.0, 7, 7, 0)
    got = roi_align_batched(torch.from_numpy(feats), torch.from_numpy(rois),
                            torch.from_numpy(batch_idx), 1 / 16.0, 7, 7, 0)
    assert got.shape == (10, 7, 7, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
