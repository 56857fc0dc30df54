"""The port's solver against the JAX package's (optax): the warmup-multistep
schedule, the parameter groups, and SGD steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from mega_pytorch_tpu.models.detectors.mega import GeneralizedRCNNMEGA as JaxMEGA
from mega_pytorch_tpu.models.detectors.rcnn import pad_gt
from mega_pytorch_tpu.solver import build as jax_solver
from mega_pytorch_tpu.structures.image_list import ImageBatch
from mega_pytorch_tpu_torch.config import get_preset
from mega_pytorch_tpu_torch.models.detectors import mega as port_mega
from mega_pytorch_tpu_torch.solver import (
    make_lr_scheduler,
    make_optimizer,
    param_labels,
    warmup_multistep_factor,
)
from mega_pytorch_tpu_torch.utils.bridge import bridge_entries
from test_mega import TINY_C, TINY_V
from torch_port_harness import port_configs


@pytest.mark.parametrize("method", ["linear", "constant"])
def test_schedule_equals_jax(method):
    """lr at iterations 0, 1, 499, 500 and around the milestones, and the
    LambdaLR's lr after each of its steps (iteration 0 before any step)."""
    cfg = get_preset("mega_R_101")
    s = cfg.SOLVER
    steps = (s.STEPS[0], s.STEPS[0] + 1000)
    want = jax_solver.warmup_multistep_schedule(s.BASE_LR, steps, s.GAMMA, s.WARMUP_FACTOR,
                                                s.WARMUP_ITERS, method)
    factor = warmup_multistep_factor(steps, s.GAMMA, s.WARMUP_FACTOR, s.WARMUP_ITERS, method)
    for it in (0, 1, 250, 499, 500, 501, steps[0] - 1, steps[0], steps[1] - 1, steps[1]):
        np.testing.assert_allclose(s.BASE_LR * factor(it), float(want(it)), rtol=1e-6,
                                   err_msg=str(it))
    cfg.SOLVER.WARMUP_METHOD = method
    opt = torch.optim.SGD([nn.Parameter(torch.zeros(2))], lr=s.BASE_LR)
    sched = make_lr_scheduler(cfg, opt)
    for it in range(4):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(want(it)), rtol=1e-6)
        opt.step()
        sched.step()


def test_param_groups_equal_jax_labels():
    """The JAX package's param_labels of the tiny MEGA's train parameters,
    by their port names, against the port's: frozen stem and layer1, a leaf
    named "bias" in the bias group, Wv_bias and u weights; FrozenBN leaves
    (frozen in JAX) are the port's buffers."""
    rs = np.random.RandomState(0)

    def images(n):
        return ImageBatch(jnp.asarray(rs.randn(n, 64, 96, 3), jnp.float32),
                          jnp.tile(jnp.array([[64.0, 96.0]]), (n, 1)))

    batch = {"local": images(3), "memory": images(2), "global": images(2)}
    gt = jax.tree_util.tree_map(lambda x: x[None],
                                pad_gt(np.array([[10.0, 10.0, 40.0, 44.0]]), np.array([2]), 4))
    model = JaxMEGA(c=TINY_C, v=TINY_V)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), batch, gt,
                                               jax.random.PRNGKey(1), train=True))["params"]
    def port_name(path, leaf):  # the bridge's name of one leaf
        nested = leaf
        for key in reversed(path):
            nested = {key.key: nested}
        return next(bridge_entries(nested))[0]

    labelled = jax.tree_util.tree_flatten_with_path(
        jax_solver.param_labels(shapes, TINY_C.freeze_at))[0]
    leaves = dict(jax.tree_util.tree_flatten_with_path(shapes)[0])
    jax_labels = {port_name(path, leaves[path]): label for path, label in labelled}

    port = port_mega.GeneralizedRCNNMEGA(*port_configs())
    port.backbone.freeze_(TINY_C.freeze_at)
    labels = param_labels(port)
    buffers = dict(port.named_buffers())
    assert set(jax_labels) == set(labels) | {n for n in jax_labels if n in buffers}
    for name, label in jax_labels.items():
        assert labels.get(name, "frozen") == label, name
    assert labels["extractor.l_attn_0.Wv_bias"] == labels["extractor.l_attn_0.u"] == "weight"
    assert labels["extractor.l_attn_0.Wg.bias"] == "bias"
    opt = make_optimizer(get_preset("mega_R_50"), port)
    groups = {g["name"]: {id(p) for p in g["params"]} for g in opt.param_groups}
    named = dict(port.named_parameters())
    for name, label in labels.items():
        if label == "frozen":
            assert all(id(named[name]) not in g for g in groups.values()), name
        else:
            assert id(named[name]) in groups[label], name


class _Toy(nn.Module):
    """Leaves named as the groups' rule sees them: a dense weight and bias,
    Wv_bias and u (weights), and a frozen stem kernel."""

    def __init__(self, arrays):
        super().__init__()
        self.fc = nn.Module()
        self.fc.weight = nn.Parameter(torch.tensor(arrays["fc"]["kernel"]))
        self.fc.bias = nn.Parameter(torch.tensor(arrays["fc"]["bias"]))
        self.Wv_bias = nn.Parameter(torch.tensor(arrays["Wv_bias"]))
        self.u = nn.Parameter(torch.tensor(arrays["u"]))
        self.backbone = nn.Module()
        self.backbone.stem = nn.Module()
        self.backbone.stem.weight = nn.Parameter(
            torch.tensor(arrays["backbone"]["stem"]["kernel"]), requires_grad=False)


def test_sgd_steps_equal_optax():
    """Five steps with fixed gradients through warmup and a milestone,
    weight decay on both groups: every parameter within 1e-6 of optax."""
    cfg = get_preset("mega_R_50")
    cfg.SOLVER.BASE_LR, cfg.SOLVER.WARMUP_ITERS, cfg.SOLVER.STEPS = 0.05, 3, (3,)
    cfg.SOLVER.WEIGHT_DECAY, cfg.SOLVER.WEIGHT_DECAY_BIAS = 1e-2, 1e-3
    rs = np.random.RandomState(0)
    arrays = {"fc": {"kernel": rs.randn(4, 3).astype(np.float32),
                     "bias": rs.randn(4).astype(np.float32)},
              "Wv_bias": rs.randn(5).astype(np.float32),
              "u": rs.randn(2, 3).astype(np.float32),
              "backbone": {"stem": {"kernel": rs.randn(3).astype(np.float32)}}}
    params = jax.tree_util.tree_map(jnp.asarray, arrays)
    tx = jax_solver.make_optimizer(cfg, params)
    state = tx.init(params)
    toy = _Toy(arrays)
    opt = make_optimizer(cfg, toy)
    sched = make_lr_scheduler(cfg, opt)
    port_params = {"fc": {"kernel": toy.fc.weight, "bias": toy.fc.bias},
                   "Wv_bias": toy.Wv_bias, "u": toy.u,
                   "backbone": {"stem": {"kernel": toy.backbone.stem.weight}}}
    for _ in range(5):
        grads = jax.tree_util.tree_map(
            lambda x: rs.randn(*x.shape).astype(np.float32), arrays)
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        for p, g in zip(jax.tree_util.tree_leaves(port_params),
                        jax.tree_util.tree_leaves(grads)):
            p.grad = torch.tensor(g)
        opt.step()
        sched.step()
        for p, want in zip(jax.tree_util.tree_leaves(port_params),
                           jax.tree_util.tree_leaves(params)):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(toy.backbone.stem.weight.detach().numpy(),
                                  arrays["backbone"]["stem"]["kernel"])
