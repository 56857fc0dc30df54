"""The detector zoo's ops in the port against the JAX package, float32 on
the CPU: the sigmoid focal loss, ROIPool (and the numpy oracle of
test_ops_zoo.py), deformable PS-ROI pooling and its modules, deformable
convolution v1 / v2, flax's "SAME" transposed convolution, the bilinear 2x
of the keypoint head, FBNet's one-group GroupNorm, and the folded form of
the stem pool's plain version against JAX's interpret-mode kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from mega_pytorch_tpu.models import layers as jax_layers
from mega_pytorch_tpu.ops import deform_conv as jax_dconv
from mega_pytorch_tpu.ops import losses as jax_losses
from mega_pytorch_tpu.ops.deform_pool import deform_roi_pooling as jax_deform_pool
from mega_pytorch_tpu.ops.pallas.stem_pool import stem_pool_packed as jax_stem_pool
from mega_pytorch_tpu.ops.roi_pool import roi_pool as jax_roi_pool
from mega_pytorch_tpu.utils.misc import jit_init
from mega_pytorch_tpu_torch.models import layers
from mega_pytorch_tpu_torch.ops import deform_conv, losses, roi_pool
from mega_pytorch_tpu_torch.ops.deform_pool import deform_roi_pooling
from mega_pytorch_tpu_torch.ops.kernels.stem_pool import stem_pool_packed
from mega_pytorch_tpu_torch.utils.bridge import state_dict_from_flax
from test_ops_zoo import np_roi_pool
from torch_port_harness import to_np

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rel):
    """Within ``rel`` of the largest magnitude."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _randomise(tree, names, rs, scale=0.05):
    """The zero-initialised leaves under ``names`` set to random values."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = (_randomise(val, (), rs, scale) if key in names
                        else _randomise(val, names, rs, scale))
        elif not names:
            out[key] = (rs.randn(*np.shape(val)) * scale).astype(np.float32)
        else:
            out[key] = np.asarray(val)
    return out


def test_sigmoid_focal_loss_matches_jax():
    rs = np.random.RandomState(0)
    logits = (rs.randn(64, 7) * 4).astype(np.float32)
    targets = rs.randint(-1, 8, size=64).astype(np.int32)  # -1 ignore, 0 background
    want = jax_losses.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(targets), 2.0, 0.25)
    got = losses.sigmoid_focal_loss(_t(logits), _t(targets).long(), 2.0, 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert (got.numpy()[targets == -1] == 0).all()


# ROIs in image coordinates at scale 1/16 on a (20, 28) map: ordinary ones,
# extents on exact bin multiples (7 * 2 and 7 * 18/7 feature pixels),
# corners at x.5 feature pixels (rounded half to even), one hanging off the
# map and a degenerate one
ROIS = np.array([
    [0.0, 0.0, 100.0, 100.0],
    [32.0, 16.0, 300.0, 250.0],
    [100.0, 50.0, 130.0, 80.0],
    [16.0, 16.0, 16.0 + 13 * 16, 16.0 + 13 * 16],  # 14 px: bins of exactly 2
    [16.0, 32.0, 16.0 + 17 * 16, 32.0 + 17 * 16],  # 18 px: bins of 18/7
    [8.0, 24.0, 8.0 + 17 * 16, 24.0 + 17 * 16],  # corners at 0.5, 1.5, 17.5, 18.5
    [400.0, 300.0, 520.0, 360.0],  # hangs off the right and bottom
    [5.0, 5.0, 5.0, 5.0],
], np.float32)


def _roi_inputs(rs, c=6):
    feat = rs.randn(2, 20, 28, c).astype(np.float32)
    rois = np.stack([ROIS, ROIS[::-1] * 0.9]).astype(np.float32)
    return feat, rois


def test_roi_pool_matches_jax_and_oracle():
    rs = np.random.RandomState(1)
    feat, rois = _roi_inputs(rs)
    got = roi_pool.roi_pool(_t(feat), _t(rois), 1 / 16.0, 7, 7).numpy()
    for lane in range(2):
        want = np.asarray(jax_roi_pool(jnp.asarray(feat[lane]), jnp.asarray(rois[lane]),
                                       1 / 16.0, 7, 7))
        np.testing.assert_array_equal(got[lane], want)
        np.testing.assert_array_equal(got[lane], np_roi_pool(feat[lane], rois[lane],
                                                             1 / 16.0, 7, 7))


def test_roi_pool_beyond_max_bin_matches_jax():
    """ROIs longer than max_bin * pooled feature pixels: strided candidates,
    truncated to integers, as the JAX op takes them."""
    rs = np.random.RandomState(2)
    feat = rs.randn(1, 60, 90, 5).astype(np.float32)
    rois = np.array([[[0.0, 0.0, 89.0, 59.0], [3.0, 1.0, 80.0, 57.0],
                      [10.0, 0.0, 40.0, 59.0]]], np.float32)
    for max_bin in (4, 5, 16):
        got = roi_pool.roi_pool(_t(feat), _t(rois), 1.0, 3, 2, max_bin).numpy()
        want = np.asarray(jax_roi_pool(jnp.asarray(feat[0]), jnp.asarray(rois[0]), 1.0, 3, 2,
                                       max_bin))
        np.testing.assert_array_equal(got[0], want)


def test_roi_pool_chunked_equals_unchunked(monkeypatch):
    rs = np.random.RandomState(3)
    feat, rois = _roi_inputs(rs, c=4)
    whole = roi_pool.roi_pool(_t(feat), _t(rois), 1 / 16.0, 7, 7)
    monkeypatch.setattr(roi_pool, "MAX_SCRATCH", 1)  # one ROI a chunk
    chunked = roi_pool.roi_pool(_t(feat), _t(rois), 1 / 16.0, 7, 7)
    assert torch.equal(whole, chunked)


# (group_size, out_size, part_size, sample_per_part, offset classes or None)
DEFORM_CASES = [
    (1, 3, None, 2, None),
    (3, 3, None, 2, None),
    (1, 3, 2, 3, 1),
    (3, 4, 3, 2, 1),
    (2, 3, 5, 2, 2),
]


@pytest.mark.parametrize("group_size,out_size,part_size,spp,classes", DEFORM_CASES)
def test_deform_roi_pooling_matches_jax(group_size, out_size, part_size, spp, classes):
    rs = np.random.RandomState(4)
    out_ch = 4
    data = rs.randn(9, 11, out_ch * group_size ** 2).astype(np.float32)
    rois = np.array([[0.0, 0.0, 60.0, 40.0], [30.0, 20.0, 150.0, 130.0],
                     [-20.0, -10.0, 30.0, 50.0], [100.0, 60.0, 200.0, 190.0],
                     [40.0, 40.0, 40.4, 40.4]], np.float32)  # off the map; tiny
    part = out_size if part_size is None else part_size
    offset = (None if classes is None else
              (rs.randn(len(rois), 2 * classes, part, part) * 0.6).astype(np.float32))
    args = (1 / 8.0, out_size, out_ch, classes is None, group_size, part_size, spp, 0.1)
    want = jax_deform_pool(jnp.asarray(data), jnp.asarray(rois),
                           None if offset is None else jnp.asarray(offset), *args)
    got = deform_roi_pooling(_t(data), _t(rois), None if offset is None else _t(offset),
                             *args)
    assert got.shape == (len(rois), out_size, out_size, out_ch)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("modulated", [False, True])
def test_deform_roi_pooling_packs_match_jax(modulated):
    """The Pack modules with their zero-initialised last layers set to
    random values, so the offsets and the mask take effect."""
    rs = np.random.RandomState(5)
    cls = (jax_layers.ModulatedDeformRoIPoolingPack if modulated
           else jax_layers.DeformRoIPoolingPack)
    kw = dict(spatial_scale=1 / 8.0, out_size=3, out_channels=4, no_trans=False,
              group_size=1, part_size=None, sample_per_part=2, trans_std=0.1,
              deform_fc_channels=16)
    data = rs.randn(10, 12, 4).astype(np.float32)
    rois = np.array([[0.0, 0.0, 60.0, 40.0], [20.0, 8.0, 90.0, 70.0],
                     [-10.0, 30.0, 40.0, 90.0]], np.float32)
    jm = cls(**kw)
    params = to_np(jit_init(jm, jax.random.PRNGKey(0), jnp.asarray(data),
                            jnp.asarray(rois))["params"])
    params = _randomise(params, ("offset_fc2", "mask_fc1"), rs, 0.5)
    want = jm.apply({"params": params}, jnp.asarray(data), jnp.asarray(rois))
    port_cls = (layers.ModulatedDeformRoIPoolingPack if modulated
                else layers.DeformRoIPoolingPack)
    port = port_cls(**kw)
    port.load_state_dict(state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        got = port(_t(data), _t(rois))
        plain = layers.DeformRoIPooling(**dict(
            {k: v for k, v in kw.items() if k != "deform_fc_channels"}, no_trans=True))(
                _t(data), _t(rois))
    _close(got, want, 1e-5)
    assert not torch.allclose(got, plain if not modulated else plain * 0.5)


def test_deform_conv2d_matches_jax():
    rs = np.random.RandomState(6)
    x = rs.randn(2, 9, 11, 5).astype(np.float32)
    w = (rs.randn(3, 3, 5, 6) * 0.2).astype(np.float32)  # (kh, kw, Cin, Cout)
    off = (rs.randn(2, 9, 11, 18) * 1.5).astype(np.float32)
    mask = rs.rand(2, 9, 11, 9).astype(np.float32)
    for m, dil in ((None, 1), (mask, 2)):
        got = deform_conv.deform_conv2d(_t(x), _t(off), _t(w.transpose(3, 2, 0, 1)),
                                        None if m is None else _t(m), dil)
        for i in range(2):
            want = jax_dconv.deform_conv2d(jnp.asarray(x[i]), jnp.asarray(off[i]),
                                           jnp.asarray(w),
                                           None if m is None else jnp.asarray(m[i]), dil)
            _close(got[i], want, 1e-5)


@pytest.mark.parametrize("modulated,groups", [(False, 1), (False, 2), (True, 1), (True, 2)])
def test_dfconv2d_matches_jax(modulated, groups):
    """DFConv2d v1 / v2 with the zero-initialised ``offset`` conv set to
    random weights; the module's own ``kernel`` crosses the bridge as a
    conv's."""
    rs = np.random.RandomState(7)
    x = rs.randn(2, 8, 10, 6).astype(np.float32)
    jm = jax_dconv.DFConv2d(features=5, with_modulated_dcn=modulated,
                            deformable_groups=groups)
    params = to_np(jit_init(jm, jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    params = _randomise(params, ("offset",), rs, 0.3)
    want = jm.apply({"params": params}, jnp.asarray(x))
    port = deform_conv.DFConv2d(6, 5, with_modulated_dcn=modulated,
                                deformable_groups=groups)
    sd = state_dict_from_flax(params)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in port.state_dict().items()}
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(_t(x))
    _close(got, want, 1e-5)


def test_dfconv2d_init_is_he_uniform():
    port = layers.init_module_(deform_conv.DFConv2d(64, 32, deformable_groups=2),
                               torch.Generator().manual_seed(0))
    limit = (6.0 / (9 * 64)) ** 0.5
    w = port.weight.detach()
    assert w.abs().max() <= limit and w.abs().max() > 0.95 * limit
    assert port.offset.weight.abs().max() == 0  # the offsets start at zero


def test_conv_transpose_same_matches_flax():
    """flax ConvTranspose(4x4/2, "SAME", transpose_kernel=True) is the port's
    ``ConvTranspose`` with padding 1; the 2x2/2 "VALID" one with padding 0."""
    rs = np.random.RandomState(8)
    x = rs.randn(2, 5, 7, 6).astype(np.float32)
    for k, padding, flax_pad in ((4, 1, "SAME"), (2, 0, "VALID")):
        jm = nn.ConvTranspose(3, (k, k), strides=(2, 2), transpose_kernel=True,
                              padding=flax_pad)
        params = to_np(jm.init(jax.random.PRNGKey(k), jnp.asarray(x))["params"])
        params["bias"] = rs.randn(3).astype(np.float32)
        want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
        port = layers.ConvTranspose(6, 3, k, stride=2, padding=padding)
        port.load_state_dict(state_dict_from_flax(params), strict=True)
        with torch.no_grad():
            got = port(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape == (2, 10, 14, 3)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bilinear_upsample2x_matches_jax_resize():
    rs = np.random.RandomState(9)
    y = rs.randn(3, 6, 5, 4).astype(np.float32)
    want = jax.image.resize(jnp.asarray(y), (3, 12, 10, 4), method="bilinear")
    got = torch.nn.functional.interpolate(_t(y).permute(0, 3, 1, 2), scale_factor=2,
                                          mode="bilinear", align_corners=False)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)


def test_one_group_norm_matches_flax():
    """FBNet's norm: flax GroupNorm(num_groups=1), eps 1e-6, returning f32."""
    rs = np.random.RandomState(10)
    x = (rs.randn(2, 5, 6, 8) * 3 + 1).astype(np.float32)
    params = {"scale": (1 + rs.randn(8) * 0.1).astype(np.float32),
              "bias": (rs.randn(8) * 0.1).astype(np.float32)}
    want = nn.GroupNorm(num_groups=1).apply({"params": params}, jnp.asarray(x))
    layer = layers.GroupNorm(8, num_groups=1, eps=1e-6)
    layer.load_state_dict(state_dict_from_flax(params))
    with torch.no_grad():
        got = layer(_t(x).permute(0, 3, 1, 2).to(torch.bfloat16)).permute(0, 2, 3, 1)
        got32 = layer(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _folded(rs, frames, rows, u, seam_rows=1):
    """``frames`` stem-conv outputs of ``rows`` packed rows stacked along T
    at stride rows + seam_rows, the seam rows random junk."""
    s = rows + seam_rows
    y = (rs.randn(1, frames * s, u, 256) * 2).astype(np.float32)
    return y, s


def test_stem_pool_folded_plain_matches_jax_interpret():
    """The plain version's ``frame_rows`` form equals JAX's interpret-mode
    kernel bit for bit on 3 folded frames with random seam rows, at a
    tile_h (5) that divides neither T (27) nor the stride (9)."""
    rs = np.random.RandomState(11)
    y, s = _folded(rs, 3, 8, 12)
    scale = (rs.rand(256) + 0.5).astype(np.float32)
    shift = rs.randn(256).astype(np.float32)
    want = jax_stem_pool(jnp.asarray(y), jnp.asarray(scale), jnp.asarray(shift), 64,
                         tile_h=5, interpret=True, frame_rows=s)
    got = stem_pool_packed(_t(y), _t(scale), _t(shift), 64, frame_rows=s)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # each frame's rows equal the unfolded form on that frame alone
    for i in range(3):
        alone = stem_pool_packed(_t(y[:, i * s:i * s + s - 1]), _t(scale), _t(shift), 64)
        assert torch.equal(got[:, i * s:i * s + s - 1], alone)
    # frame_rows = T is the unfolded layout
    assert torch.equal(stem_pool_packed(_t(y), _t(scale), _t(shift), 64, frame_rows=27),
                       stem_pool_packed(_t(y), _t(scale), _t(shift), 64))


@pytest.mark.parametrize("modulated", [False, True])
def test_deform_roi_pooling_packs_without_offsets_match_jax(modulated):
    """With ``no_trans`` a Pack has no MLP and pools without offsets."""
    rs = np.random.RandomState(12)
    kw = dict(spatial_scale=1 / 8.0, out_size=3, out_channels=2, no_trans=True,
              group_size=2, sample_per_part=2)
    data = rs.randn(10, 12, 8).astype(np.float32)
    rois = np.array([[0.0, 0.0, 60.0, 40.0], [20.0, 8.0, 90.0, 70.0]], np.float32)
    cls = (jax_layers.ModulatedDeformRoIPoolingPack if modulated
           else jax_layers.DeformRoIPoolingPack)
    want = cls(**kw).apply({}, jnp.asarray(data), jnp.asarray(rois))
    port_cls = (layers.ModulatedDeformRoIPoolingPack if modulated
                else layers.DeformRoIPoolingPack)
    port = port_cls(**kw)
    assert not list(port.parameters())
    with torch.no_grad():
        _close(port(_t(data), _t(rois)), want, 1e-5)
