"""Group norm, grouped convolutions and widened ResNets against the JAX
package: the GN stem on plain, s2d(2)- and s2d(4)-packed frames, the C4
body and the res5 head with GN or frozen BN and grouped 3x3 convolutions,
``build_resnet_c4`` / ``build_res5_head`` from the config, and a GN base
detector's ``forward_test``; float32 on the CPU, weights bridged from flax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_pytorch_tpu.config import get_preset as jax_preset
from mega_pytorch_tpu.models.backbone import resnet as jax_resnet
from mega_pytorch_tpu.models.detectors.rcnn import GeneralizedRCNN as JaxRCNN
from mega_pytorch_tpu.models.detectors.rcnn import RCNNConfig as JaxRCNNConfig
from mega_pytorch_tpu.solver import build as jax_solver
from mega_pytorch_tpu.structures.image_list import ImageBatch
from mega_pytorch_tpu.utils.misc import jit_init
from mega_pytorch_tpu_torch.config import get_preset
from mega_pytorch_tpu_torch.data.transforms import s2d_pack_frames
from mega_pytorch_tpu_torch.models.backbone import resnet
from mega_pytorch_tpu_torch.models.detectors.rcnn import (
    GeneralizedRCNN,
    RCNNConfig,
    seeded_training,
)
from mega_pytorch_tpu_torch.models.layers import GroupNorm
from mega_pytorch_tpu_torch.solver import make_optimizer, param_labels
from mega_pytorch_tpu_torch.utils.bridge import bridge_entries, state_dict_from_flax
from test_mega import TINY_C
from torch_port_harness import _perturb, match_detections, port_configs, to_np

torch.set_num_threads(2)

# f32 convolutions and group statistics summed in another order by XLA and
# PyTorch (~1e-6 relative a layer), through a few normalised layers
RTOL = ATOL = 1e-4
# ResNeXt-style tiny widths: 8 groups of 4 channels in stage 1's bottleneck
# (32, 64, 128 in the three C4 stages; 256 in res5), res2 64 channels, a
# 32-channel stem: every width a multiple of GN's 32 groups
WIDTHS = dict(num_groups=8, width_per_group=4, res2_out_channels=64)
GN_OPTS = ["MODEL.RESNETS.TRANS_FUNC", "BottleneckWithGN",
           "MODEL.RESNETS.STEM_FUNC", "StemWithGN"]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _perturb_gn(params, rs):
    """``_perturb`` (random frozen-BN statistics and GN biases) plus GN
    scales off 1, so that the bridged ``scale`` → ``weight`` is exercised."""
    def walk(tree):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = walk(val)
            elif key == "scale":
                out[key] = (np.asarray(val) * (1.0 + rs.randn(*np.shape(val)) * 0.1)
                            ).astype(np.float32)
            else:
                out[key] = val
        return out

    return walk(_perturb(to_np(params), rs))


def _load(module, params):
    module.load_state_dict(state_dict_from_flax(params), strict=True)
    return module.eval().requires_grad_(False)


def test_group_norm_layer_matches_flax():
    """The layer alone on a 6-D packed-phase tensor and on NCHW: the same
    statistics per (sample, group) over every other axis."""
    from flax import linen as nn

    rs = np.random.RandomState(0)
    x = (rs.randn(2, 3, 4, 2, 2, 64) * 5 + 1).astype(np.float32)  # (N, T, U, 2, 2, O)
    gn = nn.GroupNorm(num_groups=32, epsilon=1e-5)
    params = {"scale": (1 + rs.randn(64) * 0.1).astype(np.float32),
              "bias": (rs.randn(64) * 0.1).astype(np.float32)}
    want = np.asarray(gn.apply({"params": params}, jnp.asarray(x)))
    layer = GroupNorm(64)
    layer.load_state_dict(state_dict_from_flax(params))
    with torch.no_grad():
        got = layer(_t(x).movedim(-1, 1)).movedim(1, -1).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("factor", [1, 2, 4])
def test_gn_stem_matches_jax(factor):
    """The GN stem on plain (7x7/2), s2d(2)-packed (4x4/1) and s2d(4)-packed
    (3x3/1, then the stem conv's map unpacked: no stem pool kernel) frames;
    each against JAX's on the same input and against the port's canonical
    form."""
    rs = np.random.RandomState(3)
    x3 = (rs.randn(2, 48, 64, 3) * 50).astype(np.float32)
    x = x3 if factor == 1 else s2d_pack_frames(x3, factor)
    stem = jax_resnet.Stem(norm="gn")
    params = _perturb_gn(jax.jit(stem.init)(jax.random.PRNGKey(2), jnp.asarray(x3))["params"],
                         rs)
    want = np.asarray(stem.apply({"params": params}, jnp.asarray(x)))
    port = _load(resnet.Stem(64, norm="gn"), params)
    with torch.inference_mode():
        got = port(_t(x)).permute(0, 2, 3, 1).numpy()
        canonical = port(_t(x3)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 12, 16, 64)
    assert port.scale4.numel() == 0  # no BN affine: the kernel's inputs are never made
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, canonical, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("norm", ["gn", "frozen_bn"])
def test_grouped_resnet_c4_and_res5_head_match(norm):
    """R-14 C4 body on s2d(4)-packed frames and the dilated res5 head, with
    grouped 3x3 convolutions and the tiny widths, under each norm."""
    rs = np.random.RandomState(4)
    x = (rs.randn(2, 16, 24, 48) * 50).astype(np.float32)
    body = jax_resnet.ResNetC4(depth="R-14", norm=norm, stem_out_channels=32, **WIDTHS)
    params = _perturb_gn(jax.jit(body.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"],
                         rs)
    want = np.asarray(body.apply({"params": params}, jnp.asarray(x)))
    port = _load(resnet.ResNetC4("R-14", norm=norm, stem_out_channels=32, **WIDTHS), params)
    assert port.layer1[0].conv2.weight.shape == (32, 4, 3, 3)  # (O, I / groups, k, k)
    with torch.inference_mode():
        got = port(_t(x)).numpy()
    assert got.shape == want.shape == (2, 4, 6, 256)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    c4 = rs.randn(2, 4, 6, 256).astype(np.float32)
    head = jax_resnet.ResNetRes5Head(depth="R-14", stride_init=1, dilation=2, norm=norm,
                                     **WIDTHS)
    hp = _perturb_gn(jax.jit(head.init)(jax.random.PRNGKey(1), jnp.asarray(c4))["params"], rs)
    want = np.asarray(head.apply({"params": hp}, jnp.asarray(c4)))
    port_head = _load(resnet.ResNetRes5Head("R-14", 1, 2, norm=norm, **WIDTHS), hp)
    with torch.inference_mode():
        got = port_head(_t(c4)).numpy()
    assert got.shape == (2, 4, 6, 512) and port_head.out_channels == 512
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_build_from_config_matches_jax():
    """``build_resnet_c4`` / ``build_res5_head`` of a GN, 32x4d-grouped R-50
    config build the JAX modules' parameter trees (names and shapes, through
    the bridge), and the detector's config keeps the JAX package's rule:
    the norm from TRANS_FUNC, one group whatever NUM_GROUPS says."""
    opts = GN_OPTS + ["MODEL.RESNETS.NUM_GROUPS", "32", "MODEL.RESNETS.WIDTH_PER_GROUP", "4",
                      "MODEL.BACKBONE.CONV_BODY", "R-50-C4"]
    cfg, ref = get_preset("base_R_50"), jax_preset("base_R_50")
    for c in (cfg, ref):
        c.merge_from_list(opts + ["TPU.COMPUTE_DTYPE", "float32"])
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    body = jax.eval_shape(jax_resnet.build_resnet_c4(ref).init, jax.random.PRNGKey(0), x)
    head = jax.eval_shape(jax_resnet.build_res5_head(ref).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 2, 2, 1024), jnp.float32))
    for flax_tree, module in ((body, resnet.build_resnet_c4(cfg, "meta")),
                              (head, resnet.build_res5_head(cfg, device="meta"))):
        want = {k: tuple(v.shape) for k, v in state_dict_from_flax(
            jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   flax_tree["params"])).items()}
        got = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        assert got == want
    assert module.layer4[0].conv2.groups == 32
    c, jc = RCNNConfig.from_cfg(cfg), JaxRCNNConfig.from_cfg(ref)
    assert c.norm == jc.norm == "gn"
    assert c == RCNNConfig(**{f: getattr(jc, f) for f in RCNNConfig.__dataclass_fields__})
    detector = GeneralizedRCNN(c, device="meta")
    assert detector.backbone.layer1[0].conv2.groups == 1  # NUM_GROUPS not read
    assert isinstance(detector.extractor.head.layer4[0].bn2, GroupNorm)


def test_gn_base_detector_forward_test_matches_jax():
    """The tiny base detector with norm "gn" on 2 frames (one padded)."""
    canvas = (64, 96)
    c = TINY_C._replace(norm="gn")
    model = JaxRCNN(c=c)
    rs = np.random.RandomState(0)
    one = ImageBatch(tensors=jnp.asarray(rs.randn(1, *canvas, 3) * 40, jnp.float32),
                     sizes=jnp.array([canvas], jnp.float32))
    params = _perturb_gn(jit_init(model, jax.random.PRNGKey(0), one)["params"],
                         np.random.RandomState(1))
    pc, _ = port_configs(c)
    assert pc.norm == "gn"
    port = _load(GeneralizedRCNN(pc), params)
    images = (rs.randn(2, *canvas, 3) * 40).astype(np.float32)
    sizes = np.array([canvas, (57.0, 90.0)], np.float32)
    want = model.apply({"params": params},
                       ImageBatch(tensors=jnp.asarray(images), sizes=jnp.asarray(sizes)))
    with torch.inference_mode():
        got = port.forward_test(_t(images), _t(sizes))
        packed = port.forward_test(_t(s2d_pack_frames(images, 4)), _t(sizes))
    for dets in (got, packed):
        matched, total = match_detections(want, dets, 2)
        assert total > 0 and matched >= 0.95 * total, (matched, total)


def test_gn_training_param_labels_equal_jax():
    """The JAX package's ``param_labels`` of the tiny GN base detector, by
    the port's names, against the port's training model: its frozen-BN name
    rule freezes each GN bias (``bn*`` / ``*_bn``) while the GN scale trains
    as a weight outside the frozen stages; the optimizer's groups follow."""
    c = TINY_C._replace(norm="gn")
    one = ImageBatch(tensors=jnp.zeros((1, 64, 96, 3), jnp.float32),
                     sizes=jnp.array([[64.0, 96.0]], jnp.float32))
    params = jax.eval_shape(lambda: JaxRCNN(c=c).init(jax.random.PRNGKey(0), one))["params"]

    def port_name(path, leaf):  # the bridge's name of one leaf
        nested = leaf
        for key in reversed(path):
            nested = {key.key: nested}
        return next(bridge_entries(nested))[0]

    leaves = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    want = {port_name(path, leaves[path]): label for path, label in
            jax.tree_util.tree_flatten_with_path(
                jax_solver.param_labels(params, c.freeze_at))[0]}
    port = seeded_training(GeneralizedRCNN(port_configs(c)[0]), "cpu", None)
    got = param_labels(port)
    assert got == want
    assert got["backbone.layer2.0.bn1.bias"] == "frozen"
    assert got["backbone.layer2.0.bn1.weight"] == "weight"
    assert got["extractor.head.layer4.0.downsample_bn.bias"] == "frozen"
    assert got["backbone.stem.bn1.weight"] == "frozen"  # the frozen stem
    opt = make_optimizer(get_preset("base_R_50"), port)
    trained = {id(p) for g in opt.param_groups for p in g["params"]}
    named = dict(port.named_parameters())
    assert {n for n in named if id(named[n]) in trained} == {
        n for n, label in got.items() if label != "frozen"}
