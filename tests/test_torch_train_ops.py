"""The port's training primitives against the JAX package's: box encoding,
smooth-L1, the IoU matcher, anchor visibility, ground truth appended to the
proposals, the balanced sampler and proposal subsampling (JAX's uniform
draws injected), and the RPN and Fast R-CNN losses. Exact, or within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_pytorch_tpu.models import matcher as jax_matcher
from mega_pytorch_tpu.models import sampler as jax_sampler
from mega_pytorch_tpu.models.roi_heads import subsample as jax_subsample
from mega_pytorch_tpu.models.rpn import anchors as jax_anchors
from mega_pytorch_tpu.models.rpn import rpn as jax_rpn
from mega_pytorch_tpu.ops import losses as jax_losses
from mega_pytorch_tpu.ops.box_coder import BoxCoder as JaxBoxCoder
from mega_pytorch_tpu.structures.boxes import Boxes as JaxBoxes
from mega_pytorch_tpu_torch.models import matcher, sampler
from mega_pytorch_tpu_torch.models.roi_heads import subsample
from mega_pytorch_tpu_torch.models.rpn import anchors, rpn
from mega_pytorch_tpu_torch.ops import losses
from mega_pytorch_tpu_torch.ops.box_coder import BoxCoder
from mega_pytorch_tpu_torch.structures.boxes import Boxes

TOL = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _boxes(rs, *shape, scale=60.0):
    xy = rs.rand(*shape, 2) * scale
    wh = rs.rand(*shape, 2) * scale + 1.0
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _gt(rs, b=2, g=5, n_valid=(3, 0)):
    boxes = _boxes(rs, b, g)
    valid = np.zeros((b, g), bool)
    for i, n in enumerate(n_valid):
        valid[i, :n] = True
    labels = rs.randint(1, 31, (b, g)).astype(np.int32)
    return boxes, labels, valid


def test_encode_and_smooth_l1_equal_jax():
    rs = np.random.RandomState(0)
    ref, props = _boxes(rs, 3, 50), _boxes(rs, 3, 50)
    props[0, :4] = 0.0  # padded zero boxes: the 1e-6 width floor
    for weights in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        want = JaxBoxCoder(weights).encode(jnp.asarray(ref), jnp.asarray(props))
        got = BoxCoder(weights).encode(_t(ref), _t(props))
        _close(got, want)
    x, y = rs.randn(4, 37).astype(np.float32), rs.randn(4, 37).astype(np.float32)
    for beta in (1.0 / 9, 1.0):
        want = jax_losses.smooth_l1_loss(jnp.asarray(x), jnp.asarray(y), beta)
        got = losses.smooth_l1_loss(_t(x), _t(y), beta)
        _close(got, want)


@pytest.mark.parametrize("low_quality", [False, True])
def test_match_equals_jax(low_quality):
    """Random IoUs with ties (a ground truth's best shared by two
    predictions, two ground truths tied on one prediction) and padded
    ground truths, batched."""
    rs = np.random.RandomState(1)
    iou = np.round(rs.rand(2, 6, 40), 1).astype(np.float32)  # many ties
    iou[0, 1, [3, 9]] = 0.95
    iou[0, 2, 5] = iou[0, 4, 5] = 0.8
    valid = np.ones((2, 6), bool)
    valid[0, 4:] = False
    valid[1] = False  # no ground truth at all
    got = matcher.match(_t(iou), _t(valid), 0.7, 0.3, low_quality)
    for i in range(2):
        want = jax_matcher.match(jnp.asarray(iou[i]), jnp.asarray(valid[i]), 0.7, 0.3,
                                 low_quality)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    assert (got[1] == matcher.BELOW_LOW_THRESHOLD).all()


def test_anchor_visibility_and_gt_proposals_equal_jax():
    cell = jax_anchors.generate_cell_anchors(16, (8, 16, 32), (0.5, 1.0, 2.0))
    grid = np.asarray(jax_anchors.grid_anchors(4, 6, 16, cell))
    sizes = np.array([[64.0, 96.0], [50.0, 70.0]], np.float32)
    for thresh in (0.0, 8.0, -1.0):
        got = anchors.anchor_visibility(_t(grid), _t(sizes[:, 0:1]), _t(sizes[:, 1:2]),
                                        thresh)
        for i in range(2):
            want = jax_anchors.anchor_visibility(jnp.asarray(grid), sizes[i, 0], sizes[i, 1],
                                                 thresh)
            np.testing.assert_array_equal(np.broadcast_to(got.numpy(), (2, len(grid)))[i],
                                          np.asarray(want))
    rs = np.random.RandomState(2)
    props = JaxBoxes(boxes=jnp.asarray(_boxes(rs, 2, 7)), valid=jnp.asarray(rs.rand(2, 7) > 0.3),
                     fields={"objectness": jnp.asarray(rs.rand(2, 7).astype(np.float32))})
    gt_boxes, _, gt_valid = _gt(rs)
    want = jax_rpn.add_gt_proposals(props, jnp.asarray(gt_boxes), jnp.asarray(gt_valid))
    got = rpn.add_gt_proposals(
        Boxes(_t(props.boxes), _t(props.valid), {"objectness": _t(props.fields["objectness"])}),
        _t(gt_boxes), _t(gt_valid))
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want.boxes))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.fields["objectness"].numpy(),
                                  np.asarray(want.fields["objectness"]))


def _jax_sample_uniforms(key, n):
    return np.asarray(jax.random.uniform(key, (2, n)))


@pytest.mark.parametrize("batch_size,fraction", [(16, 0.25), (64, 0.5), (4096, 0.5)])
def test_balanced_sample_equals_jax(batch_size, fraction):
    """JAX's (2, N) uniforms injected: the same masks, lane by lane."""
    rs = np.random.RandomState(3)
    labels = rs.choice([-1, 0, 0, 0, 1, 2], (3, 200)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    uniforms = np.stack([_jax_sample_uniforms(k, 200) for k in keys])
    pos, neg = sampler.balanced_sample(_t(labels), batch_size, fraction, uniforms=_t(uniforms))
    for i in range(3):
        want_pos, want_neg = jax_sampler.balanced_sample(jnp.asarray(labels[i]), keys[i],
                                                         batch_size, fraction)
        np.testing.assert_array_equal(pos[i].numpy(), np.asarray(want_pos))
        np.testing.assert_array_equal(neg[i].numpy(), np.asarray(want_neg))
    # drawn from a generator: the budgets hold
    pos, neg = sampler.balanced_sample(_t(labels), 16, 0.25, torch.Generator().manual_seed(0))
    assert (pos.sum(-1) <= 4).all() and ((pos | neg).sum(-1) <= 16).all()
    assert not (pos & neg).any() and (labels[pos.numpy()] >= 1).all()


def _subsample_uniforms(rng, b, k):
    """The draws of the JAX ``subsample_proposals``: per image, the
    sampler's (2, K) uniforms and the (K,) slot tiebreaks."""
    samples, ties = [], []
    for r in jax.random.split(rng, b):
        r, sub = jax.random.split(r)
        samples.append(_jax_sample_uniforms(sub, k))
        ties.append(np.asarray(jax.random.uniform(r, (k,))))
    return _t(np.stack(samples)), _t(np.stack(ties))


def _subsample_inputs(seed=4, b=2, k=40):
    rs = np.random.RandomState(seed)
    gt_boxes, gt_labels, gt_valid = _gt(rs, b, 5, (3, 2))
    # proposals around the ground truth, so that every class of label occurs
    props = np.concatenate([gt_boxes[:, :, None] + rs.randn(b, 5, k // 5, 4) * 6],
                           1).reshape(b, k, 4).astype(np.float32)
    props[..., 2:] = np.maximum(props[..., 2:], props[..., :2] + 1)
    prop_valid = rs.rand(b, k) > 0.1
    return props, prop_valid, gt_boxes, gt_labels, gt_valid


@pytest.mark.parametrize("batch_size", [16, 40])
def test_subsample_and_fastrcnn_loss_equal_jax(batch_size):
    props, prop_valid, gt_boxes, gt_labels, gt_valid = _subsample_inputs()
    rng = jax.random.PRNGKey(9)
    want = jax_subsample.subsample_proposals(
        *(jnp.asarray(x) for x in (props, prop_valid, gt_boxes, gt_labels, gt_valid)), rng,
        batch_size_per_image=batch_size, positive_fraction=0.25)
    got = subsample.subsample_proposals(
        *(_t(x) for x in (props, prop_valid, gt_boxes, gt_labels, gt_valid)),
        batch_size_per_image=batch_size, positive_fraction=0.25,
        uniforms=_subsample_uniforms(rng, 2, props.shape[1]))
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want.boxes))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    _close(got.reg_targets, want.reg_targets)
    assert set(np.unique(np.asarray(want.labels))) > {0}  # positives were sampled

    rs = np.random.RandomState(5)
    logits = rs.randn(2, batch_size, 31).astype(np.float32)
    deltas = rs.randn(2, batch_size, 31 * 4).astype(np.float32)
    for agnostic in (False, True):
        w = jax_subsample.fastrcnn_loss(jnp.asarray(logits), jnp.asarray(deltas), want, agnostic)
        g = subsample.fastrcnn_loss(_t(logits), _t(deltas), got, agnostic)
        for a, b in zip(g, w):
            _close(a, b)


def test_rpn_loss_equals_jax():
    """Batched RPN loss with JAX's per-image uniforms injected; a padded
    image with no ground truth; anchors straddling the border."""
    rs = np.random.RandomState(6)
    cell = jax_anchors.generate_cell_anchors(16, (8, 16, 32), (0.5, 1.0, 2.0))
    grid = np.asarray(jax_anchors.grid_anchors(4, 6, 16, cell))
    n = len(grid)
    gt_boxes, _, gt_valid = _gt(rs, 2, 4, (2, 0))
    gt_boxes[0, 0] = grid[30]  # an anchor exactly on a ground truth
    sizes = np.array([[64.0, 96.0], [56.0, 80.0]], np.float32)
    objectness = rs.randn(2, n).astype(np.float32) * 3
    deltas = rs.randn(2, n, 4).astype(np.float32) * 0.2
    rng = jax.random.PRNGKey(11)
    uniforms = np.stack([_jax_sample_uniforms(k, n) for k in jax.random.split(rng, 2)])
    for batch_size in (16, 100000):
        want = jax_rpn.rpn_loss(jnp.asarray(grid), jnp.asarray(objectness), jnp.asarray(deltas),
                                jnp.asarray(gt_boxes), jnp.asarray(gt_valid),
                                jnp.asarray(sizes), rng, batch_size_per_image=batch_size)
        got = rpn.rpn_loss(_t(grid), _t(objectness), _t(deltas), _t(gt_boxes), _t(gt_valid),
                           _t(sizes), batch_size_per_image=batch_size, uniforms=_t(uniforms))
        for a, b in zip(got, want):
            _close(a, b)
