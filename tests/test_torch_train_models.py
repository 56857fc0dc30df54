"""The port's tiny MEGA and base ``forward_train`` against the JAX package's
train step: the four losses and every parameter's gradient.

Determinism protocol (``tests/test_parity_train.py``): the sampler batch
sizes exceed every candidate count (the ROI batch equals the proposal slots
plus the ground-truth slots, all positives allowed), so both samplers keep
every eligible anchor and proposal and the losses are sums that no random
draw changes. Gradient protocol: the JAX gradients, mapped to the port's
names by ``state_dict_from_flax`` (a pure layout map), against the port's
autograd, leaf by leaf, each within max(2e-3, 5x how far a 1e-6 relative
jitter of the parameters moves the JAX gradient itself), the median leaf
within 2e-2: gradients through stacked softmax stages are chaotic in f32.
Frozen leaves (stem and layer1 under FREEZE_CONV_BODY_AT = 2) have no
gradient in the port and exactly 0 in JAX. f32 on both sides.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_pytorch_tpu.models.detectors.mega import GeneralizedRCNNMEGA as JaxMEGA
from mega_pytorch_tpu.models.detectors.rcnn import GeneralizedRCNN as JaxRCNN
from mega_pytorch_tpu.models.detectors.rcnn import pad_gt
from mega_pytorch_tpu.structures.image_list import ImageBatch
from mega_pytorch_tpu.utils.misc import jit_init
from mega_pytorch_tpu_torch.models.detectors import mega as port_mega
from mega_pytorch_tpu_torch.models.detectors import rcnn as port_rcnn
from mega_pytorch_tpu_torch.utils.bridge import state_dict_from_flax
from test_mega import TINY_C, TINY_V
from torch_port_harness import off_relu_corner, port_configs

torch.set_num_threads(4)

H, W = 64, 96
# take-all sampling: the RPN batch above the anchor count, the ROI batch the
# proposal slots plus the ground-truth slots, every positive allowed
TAKE_ALL = dict(rpn_batch_size=100000,
                roi_batch_size=TINY_C.post_nms_top_n_train + TINY_C.max_gt_boxes,
                roi_positive_fraction=1.0)
GT_BOXES = np.array([[10.0, 10.0, 40.0, 44.0], [50.0, 20.0, 90.0, 60.0]], np.float32)
GT_LABELS = np.array([2, 17])


def _frames(rs, n):
    return (rs.randn(n, H, W, 3) * 40).astype(np.float32)


def _sizes(n):
    return np.tile(np.array([[float(H), float(W)]], np.float32), (n, 1))


def _jax_gt():
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x)[None],
                                  pad_gt(GT_BOXES, GT_LABELS, TINY_C.max_gt_boxes))


def _port_gt():
    gt = {k: torch.from_numpy(np.array(v)[None])
          for k, v in pad_gt(GT_BOXES, GT_LABELS, TINY_C.max_gt_boxes).items()}
    gt["labels"] = gt["labels"].long()
    return gt


def _flat_grads(tree):
    return {k: v.numpy() for k, v in state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _jax_side(model, inputs, gt, adjust=None):
    """(losses, gradients, movement under a 1e-6 jitter, params), numpy;
    ``adjust`` maps the initial parameters first."""
    rng = jax.random.PRNGKey(0)
    params = jit_init(model, jax.random.PRNGKey(1), inputs, gt, rng, train=True)["params"]
    if adjust is not None:
        params = adjust(jax.tree_util.tree_map(np.asarray, params))

    def losses_fn(p):
        d = model.apply({"params": p}, inputs, gt, rng, train=True)
        return sum(d.values()), d

    gradf = jax.jit(lambda p: jax.value_and_grad(losses_fn, has_aux=True)(p))
    (_, losses), grads = gradf(params)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(7), len(leaves))
    jittered = jax.tree_util.tree_unflatten(treedef, [
        leaf * (1.0 + 1e-6 * jax.random.rademacher(k, leaf.shape, jnp.float32))
        for leaf, k in zip(leaves, keys)])
    _, grads_j = gradf(jittered)
    movement = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                      grads, grads_j)
    return ({k: float(v) for k, v in losses.items()}, _flat_grads(grads),
            _flat_grads(movement), jax.tree_util.tree_map(np.asarray, params))


def _port_train_model(cls, params, *configs):
    """The port's ``cls`` with the JAX weights, prepared for training as
    ``seeded_training`` prepares it (f32 weights, frozen stages, train mode)."""
    model = cls(*configs)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    model.backbone.freeze_(model.c.freeze_at)
    return model.train()


def _compare(jax_losses, jax_grads, movement, model, port_losses):
    for name, want in jax_losses.items():
        got = float(port_losses[name].detach())
        assert abs(got - want) < 5e-4 + 1e-3 * abs(want), (name, got, want)
    params = dict(model.named_parameters())
    errs, frozen = [], 0
    for name, want in jax_grads.items():
        if name not in params:  # FrozenBN statistics: buffers in the port
            assert name.rsplit(".", 1)[-1] in ("weight", "bias", "running_mean",
                                               "running_var") and "bn" in name, name
            continue
        p = params[name]
        if not p.requires_grad:
            assert p.grad is None and np.abs(want).max() == 0.0, name
            frozen += 1
            continue
        got = p.grad.numpy()
        scale = max(np.abs(want).max(), 1e-6)
        err = np.abs(got - want).max() / scale
        tol = max(2e-3, 5.0 * np.abs(movement[name]).max() / scale)
        assert err < tol, (name, err, tol)
        errs.append(err)
    assert frozen >= 4 and len(errs) >= 20, (frozen, len(errs))
    assert float(np.median(errs)) < 2e-2, float(np.median(errs))


@functools.lru_cache(maxsize=None)
def _mega_inputs():
    rs = np.random.RandomState(0)
    local, memory, glob = _frames(rs, 3), _frames(rs, 2), _frames(rs, 2)
    return local, memory, glob


def test_mega_forward_train_equals_jax():
    """Tiny MEGA (R-14, 3 stages, global residual stage; cur + 2 local
    refs, 2 memory frames, 2 global frames): losses and gradients. The
    position weights' bias starts at 0.5 (``off_relu_corner``): at the
    initial 0 a pair whose pw lies within float noise of its relu floor
    moves its log bias by up to log 2 between two implementations of sin,
    and a tiny model has few refs a row (the losses then differ by ~2e-3;
    from 0.5 they agree to ~3e-6)."""
    c = TINY_C._replace(**TAKE_ALL)
    local, memory, glob = _mega_inputs()
    batch = {"local": ImageBatch(jnp.asarray(local), jnp.asarray(_sizes(3))),
             "memory": ImageBatch(jnp.asarray(memory), jnp.asarray(_sizes(2))),
             "global": ImageBatch(jnp.asarray(glob), jnp.asarray(_sizes(2)))}
    losses, grads, movement, params = _jax_side(JaxMEGA(c=c, v=TINY_V), batch, _jax_gt(),
                                                off_relu_corner)

    model = _port_train_model(port_mega.GeneralizedRCNNMEGA, params, *port_configs(c, TINY_V))
    port_batch = {k: (torch.from_numpy(x), torch.from_numpy(_sizes(len(x))))
                  for k, x in (("local", local), ("memory", memory), ("global", glob))}
    got = model.forward_train(port_batch, _port_gt(), torch.Generator().manual_seed(0))
    sum(got.values()).backward()
    _compare(losses, grads, movement, model, got)


def test_base_forward_train_equals_jax():
    """Tiny single-frame detector (R-14): losses and gradients."""
    c = TINY_C._replace(**TAKE_ALL)
    frames = _frames(np.random.RandomState(1), 1)
    images = ImageBatch(jnp.asarray(frames), jnp.asarray(_sizes(1)))
    losses, grads, movement, params = _jax_side(JaxRCNN(c=c), images, _jax_gt())

    pc, _ = port_configs(c, TINY_V)
    model = _port_train_model(port_rcnn.GeneralizedRCNN, params, pc)
    got = model((torch.from_numpy(frames), torch.from_numpy(_sizes(1))), _port_gt(),
                torch.Generator().manual_seed(0))
    sum(got.values()).backward()
    _compare(losses, grads, movement, model, got)


@pytest.mark.parametrize("method", ["base", "rdn", "fgfa", "dff", "mega"])
def test_training_model_build(method):
    """``build_training_model`` for every method: f32 weights, train mode,
    the stem and layer1 frozen, every other parameter trainable (FlowNetS
    and the embedding net included), FrozenBN as buffers."""
    from mega_pytorch_tpu_torch.config import get_preset
    from mega_pytorch_tpu_torch.models.detectors import build_training_model

    cfg = get_preset(f"{method}_base_R_50" if method == "rdn" else f"{method}_R_50")
    cfg.merge_from_list(["MODEL.BACKBONE.CONV_BODY", "R-14-C4"])
    model = build_training_model(cfg, "cpu", torch.Generator().manual_seed(0))
    assert model.training and cfg.TPU.COMPUTE_DTYPE == "bfloat16"
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32, name
        frozen = name.startswith(("backbone.stem.", "backbone.layer1."))
        assert p.requires_grad != frozen, name
    assert not any("bn" in n for n, _ in model.named_parameters())
