"""The flow-guided methods (DFF, FGFA) and the single-frame base detector of
the PyTorch port against the JAX package, on the CPU in float32.

The tiny configuration of test_dff_fgfa.py (R-14, 16 key proposals, 8
detections), FGFA's window shortened to 5 frames with the key at slot 2, on
64x96 frames, the same weights on both sides:

* ``bilinear_sample`` / ``warp_by_flow`` on random flows that leave the map
  on every side (exact: the same arithmetic and gathers);
* the ceil-mode 2x average pool at an odd size; ``FlowNetS`` for "dff"
  (with a perturbed, nonzero ``Convolution5_scale``) and "fgfa";
  ``EmbedNet``; ``cosine_weights``;
* ``GeneralizedRCNN.forward_test``, the heads DFF and FGFA share;
* DFF's key and non-key steps (``make_lockstep_steps_dff``) and FGFA's
  window step (``make_lockstep_step_windowed``) against the JAX package's
  over 3 lanes: carries every step, detections of every lane and step;
* lane l of the 3-lane steps against the steps on lane l's inputs alone.

Tolerances are those of test_torch_lockstep.py, and for the flow network
FLOW_ATOL (stated below).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_pytorch_tpu.engine import batched_inference as jax_engine
from mega_pytorch_tpu.models.backbone import flownet as jax_flownet
from mega_pytorch_tpu.models.detectors.dff import DFFCarry as JaxDFFCarry
from mega_pytorch_tpu.models.detectors.dff import GeneralizedRCNNDFF as JaxDFF
from mega_pytorch_tpu.models.detectors.fgfa import FGFACarry as JaxFGFACarry
from mega_pytorch_tpu.models.detectors.fgfa import GeneralizedRCNNFGFA as JaxFGFA
from mega_pytorch_tpu.models.detectors.fgfa import cosine_weights as jax_cosine_weights
from mega_pytorch_tpu.models.detectors.rcnn import GeneralizedRCNN as JaxRCNN
from mega_pytorch_tpu.models.detectors.rdn import VidConfig
from mega_pytorch_tpu.ops.warp import bilinear_sample as jax_bilinear_sample
from mega_pytorch_tpu.ops.warp import warp_by_flow as jax_warp_by_flow
from mega_pytorch_tpu.structures.image_list import ImageBatch
from mega_pytorch_tpu.utils.misc import jit_init
from mega_pytorch_tpu_torch.engine import batched_inference as engine
from mega_pytorch_tpu_torch.models.backbone import flownet
from mega_pytorch_tpu_torch.models.detectors.dff import DFFCarry, GeneralizedRCNNDFF
from mega_pytorch_tpu_torch.models.detectors.fgfa import (
    FGFACarry,
    GeneralizedRCNNFGFA,
    cosine_weights,
)
from mega_pytorch_tpu_torch.models.detectors.rcnn import GeneralizedRCNN
from mega_pytorch_tpu_torch.ops.warp import bilinear_sample, warp_by_flow
from mega_pytorch_tpu_torch.utils.bridge import state_dict_from_flax
from test_dff_fgfa import TINY_C
from test_torch_lockstep import ATOL_CARRY, ATOL_LANE, LANES, RESETS, STEPS
from torch_port_harness import (
    CANVAS,
    _perturb,
    assert_field_close,
    leaves,
    match_detections,
    port_configs,
    port_model_from,
    to_np,
)

torch.set_num_threads(2)

FGFA_V = VidConfig(method="fgfa", all_frame_interval=5, key_frame_location=2)
DFF_V = VidConfig(method="dff")
KEY_INTERVAL = 3  # DFF: steps 0, 3, 6 are key steps
# FlowNetS output against the JAX package's: ten f32 convolutions of [0, 1]
# inputs, which XLA and PyTorch round differently (~1e-6 relative per layer)
FLOW_ATOL = 1e-4


def _np(x):
    return np.asarray(x)


def _frames(seed=0):
    """Per step: plain RGB uint8 frames and sizes of every lane."""
    rs = np.random.RandomState(seed)
    frames = rs.randint(0, 256, (STEPS, LANES, *CANVAS, 3), np.uint8)
    sizes = np.tile(np.array(CANVAS, np.float32), (STEPS, LANES, 1))
    sizes[2, 1] = (57.0, 90.0)  # one frame with a padded canvas
    return frames, sizes


def _one():
    rs = np.random.RandomState(0)
    return ImageBatch(tensors=jnp.asarray(rs.randn(1, *CANVAS, 3) * 40, jnp.float32),
                      sizes=jnp.array([[float(CANVAS[0]), float(CANVAS[1])]], jnp.float32))


def _merge(a, b):
    """Two flax parameter trees, joined."""
    if not isinstance(a, dict):
        return a
    out = dict(b)
    for k, v in a.items():
        out[k] = _merge(v, b[k]) if k in b else v
    return out


def _perturb_flow(params, rs):
    """A nonzero scale branch (it initialises to zeros, so the scale map
    would be exactly 1 and its product untested)."""
    fl = params.get("flownet", params)
    if "Convolution5_scale" in fl:
        k = fl["Convolution5_scale"]["kernel"]
        fl["Convolution5_scale"] = {"kernel": (rs.randn(*k.shape) * 0.05).astype(np.float32)}
    return params


@functools.lru_cache(maxsize=None)
def _tiny(method):
    """(jax model, numpy params) of the tiny base, DFF or FGFA detector."""
    key = jax.random.PRNGKey(0)
    one = _one()
    if method == "base":
        model = JaxRCNN(c=TINY_C)
        params = jit_init(model, key, one)["params"]
    elif method == "dff":
        model = JaxDFF(c=TINY_C, v=DFF_V)
        tmp = jit_init(model, key, one, method=JaxDFF.make_key)["params"]
        carry = model.apply({"params": tmp}, one, method=JaxDFF.make_key)
        params = _merge(tmp, jit_init(model, key, carry, one,
                                      method=JaxDFF.detect_non_key)["params"])
    else:
        model = JaxFGFA(c=TINY_C, v=FGFA_V)
        tmp = jit_init(model, key, one, method=JaxFGFA.precompute)["params"]
        entry = model.apply({"params": tmp}, one, method=JaxFGFA.precompute)
        carry = model.apply({"params": tmp}, entry, one.sizes[0], method=JaxFGFA.init_carry)
        params = jit_init(model, key, carry, one, method=JaxFGFA.test_step)["params"]
    params = _perturb(to_np(params), np.random.RandomState(1))
    return model, _perturb_flow(params, np.random.RandomState(2))


def _port(method, params):
    pc, pv = port_configs(TINY_C, FGFA_V if method == "fgfa" else DFF_V)
    if method == "base":
        return port_model_from(GeneralizedRCNN, params, pc)
    cls = GeneralizedRCNNFGFA if method == "fgfa" else GeneralizedRCNNDFF
    return port_model_from(cls, params, pc, pv)


# -- modules -------------------------------------------------------------------

def test_warp_matches_jax_with_border_cases():
    rs = np.random.RandomState(0)
    for h, w in ((38, 64), (5, 7), (4, 6)):
        feats = rs.randn(2, 3, h, w, 8).astype(np.float32)
        flow = (rs.randn(2, 3, h, w, 2) * 3).astype(np.float32)
        flow[0, 0, 0, 0] = (-50.0, -50.0)  # far beyond the top-left corner
        flow[0, 1, -1, -1] = (50.0, 50.0)  # and the bottom-right one
        flow[1, 2, :, 0, 0] = -0.25  # left of the first column, inside the clamp
        flow[1, 2, 0, :, 1] = float(h)  # below the last row
        want = jax.vmap(jax.vmap(jax_warp_by_flow))(jnp.asarray(feats), jnp.asarray(flow))
        got = warp_by_flow(torch.from_numpy(feats), torch.from_numpy(flow))
        np.testing.assert_array_equal(got.numpy(), _np(want), err_msg=f"{h}x{w}")
    # bilinear_sample at raw coordinates, integral ones and the borders included
    feats = rs.randn(2, 6, 9, 4).astype(np.float32)
    xs = rs.uniform(-3, 12, (2, 6, 9)).astype(np.float32)
    ys = rs.uniform(-3, 9, (2, 6, 9)).astype(np.float32)
    xs[0, 0] = np.arange(9)
    ys[1, :, 0] = 5.0
    want = jax.vmap(jax_bilinear_sample)(*(jnp.asarray(t) for t in (feats, xs, ys)))
    got = bilinear_sample(*(torch.from_numpy(t) for t in (feats, xs, ys)))
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_avgpool2_ceil_matches_jax_at_odd_sizes():
    rs = np.random.RandomState(1)
    for h, w in ((5, 7), (6, 9), (3, 4)):
        x = rs.randn(2, h, w, 3).astype(np.float32)
        want = jax_flownet._avgpool2_ceil(jnp.asarray(x))
        got = flownet._avgpool2_ceil(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), _np(want), rtol=0,
                                   atol=1e-6, err_msg=f"{h}x{w}")


@pytest.mark.parametrize("method", ["dff", "fgfa"])
def test_flownet_matches_jax(method):
    """FlowNetS at 64x96 (its maps run 32x48 → ... → 1x1, odd sizes and
    crops on the way), with the scale map for "dff"."""
    rs = np.random.RandomState(3)
    pair = rs.rand(2, *CANVAS, 6).astype(np.float32)
    jnet = jax_flownet.FlowNetS(method=method)
    params = to_np(jnet.init(jax.random.PRNGKey(0), jnp.asarray(pair))["params"])
    params = _perturb_flow(params, rs)
    want = jnet.apply({"params": params}, jnp.asarray(pair))
    port = flownet.FlowNetS(method).eval()
    port.load_state_dict(state_dict_from_flax(params), strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(pair))
    want, got = (want, got) if method == "dff" else ((want,), (got,))
    assert got[0].shape == (2, CANVAS[0] // 16, CANVAS[1] // 16, 2)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=0, atol=FLOW_ATOL)
    if method == "dff":
        assert np.abs(got[1].numpy() - 1.0).max() > 1e-2  # the scale branch acts


def test_embednet_and_cosine_weights_match_jax():
    rs = np.random.RandomState(4)
    x = rs.randn(2, 4, 6, 1024).astype(np.float32)
    jnet = jax_flownet.EmbedNet()
    params = to_np(jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    port = flownet.EmbedNet().eval()
    port.load_state_dict(state_dict_from_flax(params), strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _np(jnet.apply({"params": params}, jnp.asarray(x))),
                               rtol=0, atol=1e-5)
    e = rs.randn(2, 5, 4, 6, 16).astype(np.float32)
    want = jax.vmap(jax_cosine_weights)(jnp.asarray(e), jnp.asarray(e[:, 2:3]))
    got = cosine_weights(torch.from_numpy(e), torch.from_numpy(e[:, 2:3]))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.numpy()[:, 2], 1.0, rtol=1e-5)


def test_base_forward_test_matches_jax():
    """The single-frame detector on 2 frames (one padded), batch leading."""
    model, params = _tiny("base")
    port = _port("base", params)
    rs = np.random.RandomState(5)
    images = (rs.randn(2, *CANVAS, 3) * 40).astype(np.float32)
    sizes = np.array([CANVAS, (57.0, 90.0)], np.float32)
    want = model.apply({"params": params},
                       ImageBatch(tensors=jnp.asarray(images), sizes=jnp.asarray(sizes)))
    with torch.inference_mode():
        got = port.forward_test(torch.from_numpy(images), torch.from_numpy(sizes))
    matched, total = match_detections(want, got, 2)
    assert total > 0 and matched >= 0.95 * total, (matched, total)


# -- lockstep steps ------------------------------------------------------------

def _port_stream(method, port, lanes=tuple(range(LANES))):
    """The port's lockstep steps over ``lanes`` → per step (carry, dets) numpy."""
    frames, sizes = _frames()
    sel, carries, out = list(lanes), None, []
    if method == "dff":
        key_step, nonkey_step = engine.make_lockstep_steps_dff(port)
    else:
        step = engine.make_lockstep_step_windowed(port)
    for s in range(STEPS):
        args = (torch.from_numpy(frames[s][sel]), torch.from_numpy(sizes[s][sel]))
        if method == "dff":
            fn = key_step if s % KEY_INTERVAL == 0 else nonkey_step
            carries, dets = fn(carries, *args)
        else:
            carries, dets = step(carries, *args, torch.from_numpy(RESETS[s][sel]))
        out.append((carries._make(x.numpy() for x in carries),
                    dets._make(x.numpy() for x in dets)))
    return out


@pytest.fixture(scope="module", params=["dff", "fgfa"])
def streams(request):
    method = request.param
    model, params = _tiny(method)
    port = _port(method, params)
    frames, sizes = _frames()
    h, w = CANVAS
    f, c = (h // 16, w // 16), 1024
    if method == "dff":
        key_step, nonkey_step = jax_engine.make_lockstep_steps_dff(model)
        # the first step is a key step, which reads no carry
        carries = JaxDFFCarry(jnp.zeros((LANES, h, w, 3)), jnp.zeros((LANES, *f, c)),
                              jnp.zeros((LANES, 2)))
    else:
        step = jax_engine.make_lockstep_step_windowed(model)
        t = FGFA_V.all_frame_interval  # every lane resets on step 0
        carries = JaxFGFACarry(jnp.zeros((LANES, t, h, w, 3)),
                               jnp.zeros((LANES, t, *f, 3 * c)), jnp.zeros((LANES, t, 2)))
    jax_out = []
    for s in range(STEPS):
        args = (jnp.asarray(frames[s][:, None]), jnp.asarray(sizes[s][:, None]))
        if method == "dff":
            fn = key_step if s % KEY_INTERVAL == 0 else nonkey_step
            carries, dets = fn(params, carries, *args)
        else:
            carries, dets = step(params, carries, *args, jnp.asarray(RESETS[s]))
        jax_out.append((to_np(carries), to_np(dets)))
    return method, jax_out, _port_stream(method, port), port


def test_flow_methods_lockstep_carry_matches_jax_every_step(streams):
    method, jax_out, port_out, _ = streams
    fields = DFFCarry._fields if method == "dff" else FGFACarry._fields
    for s, ((jc, _), (pc, _)) in enumerate(zip(jax_out, port_out)):
        for field in fields:
            assert_field_close(getattr(jc, field), getattr(pc, field), ATOL_CARRY,
                               f"{method} {field} step {s}")


def test_flow_methods_lockstep_detections_match_jax(streams):
    method, jax_out, port_out, _ = streams
    matched = total = 0
    for (_, jd), (_, pd) in zip(jax_out, port_out):
        m, t = match_detections(jd, pd, LANES)
        matched, total = matched + m, total + t
    assert total > 0, method
    assert matched >= 0.95 * total, (method, matched, total)


def test_flow_methods_lane_equals_one_lane_step(streams):
    """Lane l of the 3-lane steps equals the steps on lane l's inputs alone,
    run as 3 copies of the lane and read at row l (the CPU convolutions and
    GEMMs round by batch size and row position; test_torch_rdn.py)."""
    method, _, port_out, port = streams
    for lane in range(LANES):
        solo = _port_stream(method, port, lanes=(lane,) * LANES)
        for s, ((pc, pd), (sc, sd)) in enumerate(zip(port_out, solo)):
            for got, want in zip(leaves(pc) + list(pd), leaves(sc) + list(sd)):
                msg = f"{method} lane {lane} step {s}"
                if want.dtype == np.float32:
                    np.testing.assert_allclose(got[lane], want[lane], rtol=0,
                                               atol=ATOL_LANE, err_msg=msg)
                else:  # masks, labels
                    np.testing.assert_array_equal(got[lane], want[lane], err_msg=msg)
