"""Detectron (Caffe2) pickle ingestion: the port's
``utils/model_ingest.load_c2_weights`` against the JAX package's.

A synthetic blob dict at the tiny harness MEGA's widths (R-14: the stem and
one bottleneck a stage, res2-res5), with the ``_momentum`` and ``fc1000``
blobs a Detectron pickle also holds, is pickled with protocol 2. JAX's
loader overlays it on the JAX parameters, the port's on the port model
bridged from the same parameters (FrozenBN statistics at a fresh model's 0
and 1, as the pickles assume). Every tensor of the port equals the JAX
tree through the bridge bit for bit, res5 sits under ``extractor.head``,
and the C4 bodies of both packages agree on s2d(4)-packed frames within the
harness's f32 tolerance: the port's stem re-derives its packed 3x3 kernel
and the kernel's BN affine from the loaded 7x7 kernel and statistics, so a
stale packed stem would fail this forward while every tensor matches.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_pytorch_tpu.data.transforms import s2d_pack_frames
from mega_pytorch_tpu.models.backbone.resnet import ResNetC4 as JaxResNetC4
from mega_pytorch_tpu.utils import model_ingest as jax_ingest
from mega_pytorch_tpu_torch.utils import model_ingest
from mega_pytorch_tpu_torch.utils.bridge import state_dict_from_flax
from test_mega import TINY_C
from torch_port_harness import CANVAS, port_mega_from, tiny_mega

torch.set_num_threads(2)

# the harness's f32 tolerance of a C4 body (test_torch_modules.py): XLA's and
# PyTorch's CPU convolutions round differently
RTOL_BODY = ATOL_BODY = 1e-4
_BRANCH = {"conv1": "2a", "conv2": "2b", "conv3": "2c", "downsample_conv": "1"}
_BN = {"bn1": "2a", "bn2": "2b", "bn3": "2c", "downsample_bn": "1"}


def _identity_bn(tree):
    """FrozenBN statistics at a fresh model's running mean 0 and variance 1."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _identity_bn(val)
        elif key == "running_mean":
            out[key] = np.zeros_like(val)
        elif key == "running_var":
            out[key] = np.ones_like(val)
        else:
            out[key] = val
    return out


def _blobs(params, rs):
    """Detectron blobs for the backbone (stem, res2-res4) and the head's res5,
    shaped as the parameters (conv weights OIHW), drawn from ``rs``; plus a
    momentum blob per conv and the classifier's fc1000."""
    blobs = {}

    def draw(shape, scale=1.0):
        return (rs.randn(*shape) * scale).astype(np.float32)

    stem = params["backbone"]["stem"]
    blobs["conv1_w"] = draw(np.transpose(stem["conv1"]["kernel"], (3, 2, 0, 1)).shape, 0.05)
    blobs["res_conv1_bn_s"] = 1.0 + draw((64,), 0.1)
    blobs["res_conv1_bn_b"] = draw((64,), 0.1)
    stages = [(i, params["backbone"][f"layer{i}"]) for i in (1, 2, 3)]
    stages.append((4, params["extractor"]["head"]["layer4"]))
    for i, layer in stages:
        for block, mods in layer.items():
            prefix = f"res{i + 1}_{block}_branch"
            for mod, leaves in mods.items():
                if mod in _BRANCH:
                    shape = np.transpose(leaves["kernel"], (3, 2, 0, 1)).shape
                    blobs[f"{prefix}{_BRANCH[mod]}_w"] = draw(shape, 1.0 / np.sqrt(
                        np.prod(shape[1:])))
                    blobs[f"{prefix}{_BRANCH[mod]}_w_momentum"] = draw(shape)
                else:
                    width = leaves["weight"].shape
                    blobs[f"{prefix}{_BN[mod]}_bn_s"] = 1.0 + draw(width, 0.1)
                    blobs[f"{prefix}{_BN[mod]}_bn_b"] = draw(width, 0.1)
    blobs["fc1000_w"] = draw((1000, 2048))
    blobs["fc1000_b"] = draw((1000,))
    return blobs


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    """(blobs, JAX-loaded params, the port model loaded from the pickle)."""
    params = _identity_bn(tiny_mega()[1])
    blobs = _blobs(params, np.random.RandomState(0))
    path = tmp_path_factory.mktemp("c2") / "R-14.pkl"
    with open(path, "wb") as f:
        pickle.dump({"blobs": blobs}, f, protocol=2)
    jax_params = jax_ingest.load_c2_weights(str(path), params)
    port = port_mega_from(params)
    assert model_ingest.load_c2_weights(str(path), port) is port
    return blobs, jax_params, port


def test_c2_blob_names_match_jax():
    names = ["conv1_w", "res_conv1_bn_s", "conv1_bn_b", "res2_0_branch1_w",
             "res3_2_branch2b_bn_s", "res5_2_branch2c_b", "res4_22_branch2a_bn_b",
             "res2_0_branch2a_w_momentum", "fc1000_w", "pred_w", "res2_0_branch3_w"]
    for name in names:
        assert model_ingest.c2_blob_to_path(name) == jax_ingest.c2_blob_to_path(name), name
    assert model_ingest.c2_blob_to_path("res5_0_branch2a_w") == (
        ("layer4", "0", "conv1", "kernel"), True)


def test_c2_tensors_equal_jax_bit_for_bit(loaded):
    blobs, jax_params, port = loaded
    want = state_dict_from_flax(jax_params)
    got = port.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        assert torch.equal(got[name], w), name
    # res5 under the box head's extractor; skipped blobs reach nothing
    np.testing.assert_array_equal(got["extractor.head.layer4.0.conv1.weight"].numpy(),
                                  blobs["res5_0_branch2a_w"])
    np.testing.assert_array_equal(got["backbone.stem.conv1.weight"].numpy(), blobs["conv1_w"])
    np.testing.assert_array_equal(got["backbone.layer1.0.downsample_bn.weight"].numpy(),
                                  blobs["res2_0_branch1_bn_s"])
    tree = model_ingest.convert_c2_blobs(blobs)
    assert set(tree) == {"backbone", "extractor"} and set(tree["extractor"]) == {"head"}
    assert "fc1000" not in str(tree) and "momentum" not in str(tree)


def test_c2_loaded_c4_body_matches_jax(loaded):
    _, jax_params, port = loaded
    rs = np.random.RandomState(1)
    frames = s2d_pack_frames(rs.randint(0, 256, (2, *CANVAS, 3)).astype(np.float32) - 128, 4)
    body = JaxResNetC4(depth=TINY_C.depth, freeze_at=TINY_C.freeze_at,
                       stride_in_1x1=TINY_C.stride_in_1x1, norm=TINY_C.norm)
    want = np.asarray(body.apply({"params": jax_params["backbone"]}, jnp.asarray(frames)))
    with torch.inference_mode():
        got = port.backbone(torch.from_numpy(np.ascontiguousarray(frames))).numpy()
    assert got.shape == want.shape == (2, CANVAS[0] // 16, CANVAS[1] // 16, 1024)
    np.testing.assert_allclose(got, want, rtol=RTOL_BODY, atol=ATOL_BODY)


def test_c2_pickle_refuses_other_globals(tmp_path):
    path = tmp_path / "bad.pkl"
    with open(path, "wb") as f:
        pickle.dump({"blobs": {"conv1_w": np.zeros((4, 3, 7, 7), np.float32)},
                     "cfg": pytest.approx(1.0)}, f, protocol=2)
    with pytest.raises(pickle.UnpicklingError):
        model_ingest.load_c2_weights(str(path), torch.nn.Module())
