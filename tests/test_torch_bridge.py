"""Weight bridge: the flax parameter tree of the tiny MEGA loads strictly into
the PyTorch port, and the fc0 flatten order of pooled ROI features agrees."""

import jax.numpy as jnp
import numpy as np
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
