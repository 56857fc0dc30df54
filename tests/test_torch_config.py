"""The port's config layer against the JAX package's: every preset key by
key, ``merge_from_file`` over the repo's ``configs/**/*.yaml``,
``merge_from_list``, and
``build_detection_model``'s parameters against the JAX model's param tree
through the weight bridge (names and shapes), at tiny widths for every
method and at full width for MEGA R-101 on the ``meta`` device."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from mega_pytorch_tpu.config import PRESETS as JAX_PRESETS
from mega_pytorch_tpu.config import get_default_cfg as jax_default_cfg
from mega_pytorch_tpu.config import get_preset as jax_preset
from mega_pytorch_tpu.models.detectors import build_detection_model as jax_build
from mega_pytorch_tpu.structures.image_list import ImageBatch
from mega_pytorch_tpu.utils.model_ingest import _union_trees
from mega_pytorch_tpu_torch.config import PRESETS, get_default_cfg, get_preset
from mega_pytorch_tpu_torch.models.detectors import build_detection_model, detection_model
from mega_pytorch_tpu_torch.utils.bridge import bridge_entries

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))

# tiny widths for the CPU (test_cli.py's TINY_OPTS, R-14 backbone)
TINY_OPTS = [
    "MODEL.BACKBONE.CONV_BODY", "R-14-C4",
    "MODEL.RPN.ANCHOR_SIZES", "(8, 16, 32)",
    "MODEL.RPN.PRE_NMS_TOP_N_TEST", "64",
    "MODEL.RPN.POST_NMS_TOP_N_TEST", "16",
    "MODEL.VID.RPN.REF_PRE_NMS_TOP_N", "32",
    "MODEL.VID.RPN.REF_POST_NMS_TOP_N", "8",
    "MODEL.ROI_HEADS.DETECTIONS_PER_IMG", "5",
    "MODEL.VID.MEGA.ALL_FRAME_INTERVAL", "3",
    "MODEL.VID.MEGA.KEY_FRAME_LOCATION", "1",
    "MODEL.VID.MEGA.MEMORY.SIZE", "3",
    "MODEL.VID.MEGA.GLOBAL.SIZE", "2",
    "INPUT.MIN_SIZE_TEST", "48",
    "INPUT.MAX_SIZE_TEST", "64",
    "TPU.CANVAS_HEIGHT", "48",
    "TPU.CANVAS_WIDTH", "64",
    "TPU.COMPUTE_DTYPE", "float32",
]


def _assert_same_tree(got, want, where="cfg"):
    assert type(got).__name__ == type(want).__name__, where
    if isinstance(want, dict):
        assert list(got.keys()) == list(want.keys()), where
        for k in want:
            _assert_same_tree(got[k], want[k], f"{where}.{k}")
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


def test_presets_equal_jax():
    assert list(PRESETS) == list(JAX_PRESETS) and len(PRESETS) == 11
    _assert_same_tree(get_default_cfg(), jax_default_cfg())
    for name in PRESETS:
        _assert_same_tree(get_preset(name), jax_preset(name), name)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, ROOT))
def test_merge_from_file_equals_jax(path):
    """Each repo config over the defaults and over a preset."""
    for make, make_jax in ((get_default_cfg, jax_default_cfg),
                           (lambda: get_preset("mega_R_101"), lambda: jax_preset("mega_R_101"))):
        cfg, ref = make(), make_jax()
        cfg.merge_from_file(path)
        ref.merge_from_file(path)
        _assert_same_tree(cfg, ref, os.path.basename(path))


def test_merge_from_list_equals_jax():
    """CLI opts over every preset; unknown keys and mistyped values are
    refused on both sides."""
    opts = TINY_OPTS + ["MODEL.VID.MEGA.GLOBAL.ENABLE", "False", "MODEL.WEIGHT", "w.pth",
                        "INPUT.PIXEL_MEAN", "[1.0, 2.0, 3.0]", "DATASETS.TEST",
                        "('VID_val_frames',)", "SOLVER.BASE_LR", "0.01"]
    for name in PRESETS:
        cfg, ref = get_preset(name), jax_preset(name)
        cfg.merge_from_list(opts)
        ref.merge_from_list(opts)
        _assert_same_tree(cfg, ref, name)
    with pytest.raises(KeyError):
        get_preset("base_R_50").merge_from_list(["MODEL.NOT_A_KEY", "1"])
    with pytest.raises(TypeError):
        get_preset("base_R_50").merge_from_list(["MODEL.RPN.NMS_THRESH", "abc"])


def _jax_param_shapes(cfg, method):
    """The JAX model's inference param tree (shapes only), initialised
    through the method's streaming path as ``init_inference_params`` does."""
    model = jax_build(cfg)
    one = ImageBatch(tensors=jnp.zeros((1, 48, 64, 3), jnp.float32),
                     sizes=jnp.array([[48.0, 64.0]], jnp.float32))

    def init(key, im):
        if method == "base":
            return model.init(key, im, train=False)["params"]
        if method == "dff":
            p1 = model.init(key, im, method=model.make_key)["params"]
            carry = model.apply({"params": p1}, im, method=model.make_key)
            return _union_trees(p1, model.init(key, carry, im,
                                               method=model.detect_non_key)["params"])
        p1 = model.init(key, im, method=model.precompute)["params"]
        entry = model.apply({"params": p1}, im, method=model.precompute)
        carry = model.apply({"params": p1}, entry, im.sizes[0], method=model.init_carry)
        return _union_trees(p1, model.init(key, carry, im, method=model.test_step)["params"])

    return jax.eval_shape(init, jax.random.PRNGKey(0), one)


def _assert_bridged_shapes_equal(port, shapes):
    want = {name: tuple(np.transpose(np.empty(s.shape, np.bool_), axes).shape)
            if axes else tuple(s.shape) for name, s, axes in bridge_entries(shapes)}
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert sorted(got) == sorted(want), (sorted(set(got) ^ set(want)))[:10]
    assert got == want


@pytest.mark.parametrize("preset", ["base_R_50", "rdn_R_101", "fgfa_R_50", "dff_R_50",
                                    "mega_R_50"])
def test_build_detection_model_matches_jax_tree(preset):
    """At tiny widths: every parameter and frozen-BN buffer of the port's
    model is a leaf of the JAX model's tree through the bridge, of the
    bridged shape, and the configs agree field by field."""
    cfg = get_preset(preset)
    cfg.merge_from_list(TINY_OPTS)
    ref = jax_preset(preset)
    ref.merge_from_list(TINY_OPTS)
    method = cfg.MODEL.VID.METHOD if cfg.MODEL.VID.ENABLE else "base"
    port = build_detection_model(cfg, "cpu")
    jax_model = jax_build(ref)
    for f in type(port.c).__dataclass_fields__:
        assert getattr(port.c, f) == getattr(jax_model.c, f), f
    if method != "base":
        for f in type(port.v).__dataclass_fields__:
            assert getattr(port.v, f) == getattr(jax_model.v, f), f
    assert not port.training and all(not p.requires_grad for p in port.parameters())
    _assert_bridged_shapes_equal(port, _jax_param_shapes(ref, method))


def test_mega_r101_tree_matches_jax_on_meta():
    """MEGA R-101 at full width (fc0 100352 wide: the preset reduces no
    channel), names and shapes only: the port's modules on ``meta``."""
    cfg = get_preset("mega_R_101")
    port = detection_model(cfg, device="meta")
    _assert_bridged_shapes_equal(port, _jax_param_shapes(jax_preset("mega_R_101"), "mega"))
    assert tuple(port.extractor.l_fcs_0.weight.shape) == (1024, 2048 * 49)
