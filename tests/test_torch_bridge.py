"""Weight bridge: the flax parameter trees of the tiny MEGA, RDN, FGFA, DFF
and base detectors load strictly into the PyTorch port, the fc0 flatten
order of pooled ROI features agrees, and transposed-convolution kernels
bridge without a flip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from mega_pytorch_tpu.models.roi_heads.mega_extractor import MEGAFeatureExtractor
from mega_pytorch_tpu_torch.models.roi_heads.mega_extractor import (
    MEGAFeatureExtractor as PortExtractor,
)
from mega_pytorch_tpu_torch.utils.bridge import state_dict_from_flax
from torch_port_harness import port_mega_from, tiny_mega

torch.set_num_threads(2)


def test_bridge_loads_tiny_mega_strictly():
    _, params = tiny_mega()
    sd = state_dict_from_flax(params)
    model = port_mega_from(params)  # load_state_dict(strict=True) inside
    assert set(model.state_dict()) == set(sd)
    ref = model.state_dict()
    # layouts: conv OIHW, dense (out, in), attention leaves as in flax
    np.testing.assert_array_equal(
        ref["backbone.stem.conv1.weight"].numpy(),
        params["backbone"]["stem"]["conv1"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        ref["backbone.layer1.0.conv2.weight"].numpy(),
        params["backbone"]["layer1"]["0"]["conv2"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        ref["extractor.l_attn_0.Wq.weight"].numpy(),
        params["extractor"]["l_attn_0"]["Wq"]["kernel"].T)
    np.testing.assert_array_equal(
        ref["extractor.l_attn_0.Wg.kernel"].numpy(),
        params["extractor"]["l_attn_0"]["Wg"]["kernel"])
    assert ref["extractor.g_attn_1.Wv_kernel"].shape == (16, 1024, 64)
    assert "extractor.g_attn_0.Wg.kernel" not in ref
    bn = params["backbone"]["layer2"]["0"]["bn1"]
    np.testing.assert_array_equal(
        ref["backbone.layer2.0.bn1.running_var"].numpy(), bn["running_var"])


def test_fc0_flatten_order_matches():
    """Pooled features flatten in (h, w, c) order on both sides, so fc0
    bridges as a plain dense layer."""
    rs = np.random.RandomState(0)
    feat = rs.randn(6, 8, 256).astype(np.float32)
    rois = np.array([[3.0, 5.0, 60.0, 90.0], [10.0, 0.0, 40.0, 30.0]], np.float32)

    class Fc0(nn.Module):
        @nn.compact
        def __call__(self, feat, rois):
            ext = MEGAFeatureExtractor(depth="R-14", reduce_channel=True, stage=1,
                                       global_enable=False, name="extractor")
            return ext.fc0(ext.pool_flat(feat, rois))

    import jax

    mod = Fc0()
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(feat), jnp.asarray(rois))
    fc = jax.tree_util.tree_map(np.asarray, params["params"]["extractor"]["l_fcs_0"])
    want = np.asarray(mod.apply(params, jnp.asarray(feat), jnp.asarray(rois)))

    port = PortExtractor(depth="R-14", reduce_channel=True, stage=1,
                         global_enable=False)
    sd = state_dict_from_flax({"l_fcs_0": fc})
    port.l_fcs_0.load_state_dict(
        {k.split(".", 1)[1]: v for k, v in sd.items()}, strict=True)
    with torch.inference_mode():
        got = port.fc0(port.pool_flat(torch.from_numpy(feat)[None],
                                      torch.from_numpy(rois)[None]))[0]
    assert fc["kernel"].shape == (7 * 7 * 256, 1024)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_conv_transpose_bridges_without_a_flip():
    """A flax ``ConvTranspose(transpose_kernel=True)`` kernel, stored
    (kh, kw, out, in), becomes ``conv_transpose2d``'s (in, out, kh, kw)
    weight by the bridge's 4-D rule, with no spatial flip (stride 2, VALID,
    4x4: FlowNetS's upsamplers)."""
    from mega_pytorch_tpu_torch.models.layers import ConvTranspose

    rs = np.random.RandomState(0)
    x = rs.randn(2, 5, 7, 3).astype(np.float32)
    mod = nn.ConvTranspose(6, (4, 4), strides=(2, 2), padding="VALID",
                           transpose_kernel=True)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = {"kernel": np.asarray(params["kernel"]),
              "bias": rs.randn(6).astype(np.float32)}
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    port = ConvTranspose(3, 6, 4, 2)
    port.load_state_dict(state_dict_from_flax(params), strict=True)
    np.testing.assert_array_equal(port.weight.detach().numpy(),
                                  params["kernel"].transpose(3, 2, 0, 1))
    with torch.inference_mode():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 12, 16, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("method", ["rdn", "fgfa", "dff", "base"])
def test_bridge_loads_method_trees_strictly(method):
    """The tiny RDN (advanced stage), FGFA, DFF and base detectors' flax
    trees, abstractly initialised, load strictly into the port's models:
    RDN's attentions have no ``u``, DFF's flow net has the scale branch."""
    from mega_pytorch_tpu.models.detectors.dff import GeneralizedRCNNDFF
    from mega_pytorch_tpu.models.detectors.fgfa import GeneralizedRCNNFGFA
    from mega_pytorch_tpu.models.detectors.rcnn import GeneralizedRCNN
    from mega_pytorch_tpu.models.detectors.rdn import GeneralizedRCNNRDN, VidConfig
    from mega_pytorch_tpu.structures.image_list import ImageBatch
    from mega_pytorch_tpu_torch.models import detectors
    from test_dff_fgfa import TINY_C as FLOW_C
    from test_rdn import TINY_C as RDN_C
    from test_rdn import TINY_V as RDN_V
    from torch_port_harness import port_configs

    packed = method == "rdn"
    shape = (1, 16, 24, 48) if packed else (1, 64, 96, 3)
    one = ImageBatch(tensors=jnp.zeros(shape), sizes=jnp.array([[64.0, 96.0]]))
    key = jax.random.PRNGKey(0)
    if method == "base":
        model = GeneralizedRCNN(c=FLOW_C)
        tree = jax.eval_shape(lambda: model.init(key, one))
        port = detectors.GeneralizedRCNN(port_configs(FLOW_C, RDN_V)[0])
    elif method == "dff":
        v = VidConfig(method="dff")
        model = GeneralizedRCNNDFF(c=FLOW_C, v=v)

        def init():
            tmp = model.init(key, one, method=model.make_key)
            carry = model.apply(tmp, one, method=model.make_key)
            rest = model.init(key, carry, one, method=model.detect_non_key)
            return {"params": {**tmp["params"], **rest["params"]}}

        tree = jax.eval_shape(init)
        port = detectors.GeneralizedRCNNDFF(*port_configs(FLOW_C, v))
    else:
        c, v, cls, pcls = (
            (RDN_C, RDN_V, GeneralizedRCNNRDN, detectors.GeneralizedRCNNRDN)
            if method == "rdn" else
            (FLOW_C, VidConfig(method="fgfa", all_frame_interval=5, key_frame_location=2),
             GeneralizedRCNNFGFA, detectors.GeneralizedRCNNFGFA))
        model = cls(c=c, v=v)

        def init():
            tmp = model.init(key, one, method=model.precompute)
            entry = model.apply(tmp, one, method=model.precompute)
            carry = model.apply(tmp, entry, one.sizes[0], method=model.init_carry)
            return model.init(key, carry, one, method=model.test_step)

        tree = jax.eval_shape(init)
        port = pcls(*port_configs(c, v))
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), tree["params"])
    sd = state_dict_from_flax(params)
    port.load_state_dict(sd, strict=True)
    assert set(port.state_dict()) == set(sd)
    if method == "rdn":
        assert "extractor.attn_3.Wg.kernel" in sd and "extractor.fcs_2.weight" in sd
        assert not [k for k in sd if k.endswith(".u")]
    if method == "dff":
        assert sd["flownet.Convolution5_scale.weight"].shape == (1024, 194, 1, 1)
