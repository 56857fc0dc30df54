"""RDN in the PyTorch port against the JAX package, on the CPU in float32.

The tiny RDN of test_rdn.py (R-14, 10 refs and 24 key proposals a frame, 2
base stages and the advanced stage, window 5 with the key at slot 2) with
the same weights on both sides:

* ``RelationAttention(use_u_bias=False)``: no ``u`` parameter, and the same
  output as the JAX module, per lane;
* ``RDNFeatureExtractor.extract_test`` with its advanced stage;
* the lockstep step (``make_lockstep_step_windowed``) against the JAX
  package's over 3 lanes with staggered resets on s2d(4)-packed uint8
  frames: the carry every step, the detections of every lane and step;
* lane l of the 3-lane step against the step on lane l's inputs alone.

Tolerances are those of test_torch_lockstep.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_pytorch_tpu.data.transforms import s2d_pack_frames
from mega_pytorch_tpu.engine import batched_inference as jax_engine
from mega_pytorch_tpu.models.detectors.rdn import GeneralizedRCNNRDN as JaxRDN
from mega_pytorch_tpu.models.roi_heads.attention import (
    RelationAttention as JaxRelationAttention,
)
from mega_pytorch_tpu.models.roi_heads.vid_extractors import (
    RDNFeatureExtractor as JaxExtractor,
)
from mega_pytorch_tpu.structures.image_list import ImageBatch
from mega_pytorch_tpu.utils.misc import jit_init
from mega_pytorch_tpu_torch.engine import batched_inference as engine
from mega_pytorch_tpu_torch.models.detectors.rdn import GeneralizedRCNNRDN, RDNCarry
from mega_pytorch_tpu_torch.models.roi_heads.attention import RelationAttention
from mega_pytorch_tpu_torch.models.roi_heads.vid_extractors import RDNFeatureExtractor
from mega_pytorch_tpu_torch.utils.bridge import state_dict_from_flax
from test_rdn import TINY_C, TINY_V
from test_torch_lockstep import ATOL_BOX, ATOL_CARRY, ATOL_LANE, LANES, RESETS, STEPS
from torch_port_harness import (
    CANVAS,
    _perturb,
    assert_field_close,
    leaves,
    match_detections,
    off_relu_corner,
    port_configs,
    port_model_from,
    to_np,
)

torch.set_num_threads(2)

BOX_FIELDS = ("rois", "key_rois")


def _frames():
    """Per step: s2d(4)-packed uint8 frames and sizes of every lane."""
    rs = np.random.RandomState(0)
    frames = s2d_pack_frames(rs.randint(0, 256, (STEPS, LANES, *CANVAS, 3), np.uint8), 4)
    sizes = np.tile(np.array(CANVAS, np.float32), (STEPS, LANES, 1))
    sizes[2, 1] = (57.0, 90.0)  # one frame with a padded canvas
    return frames, sizes


@functools.lru_cache(maxsize=None)
def _tiny_rdn():
    """(jax model, numpy params) of the tiny RDN, perturbed as the MEGA
    harness perturbs its weights, the Wg biases off the relu corner."""
    model = JaxRDN(c=TINY_C, v=TINY_V)
    rs = np.random.RandomState(0)
    one = ImageBatch(
        tensors=jnp.asarray(rs.randn(1, CANVAS[0] // 4, CANVAS[1] // 4, 48) * 50,
                            jnp.float32),
        sizes=jnp.array([[float(CANVAS[0]), float(CANVAS[1])]], jnp.float32))
    tmp = jit_init(model, jax.random.PRNGKey(0), one, method=JaxRDN.precompute)["params"]
    entry = model.apply({"params": tmp}, one, method=JaxRDN.precompute)
    carry = model.apply({"params": tmp}, entry, one.sizes[0], method=JaxRDN.init_carry)
    params = jit_init(model, jax.random.PRNGKey(0), carry, one,
                      method=JaxRDN.test_step)["params"]
    return model, off_relu_corner(_perturb(to_np(params), np.random.RandomState(1)))


def _port_rdn(params):
    return port_model_from(GeneralizedRCNNRDN, params, *port_configs(TINY_C, TINY_V))


def _to_numpy(carry, dets):
    return carry._make(x.numpy() for x in carry), dets._make(x.numpy() for x in dets)


def _port_stream(port, lanes=tuple(range(LANES))):
    """The port's lockstep steps over ``lanes`` → per step (carry, dets) numpy."""
    frames, sizes = _frames()
    step = engine.make_lockstep_step_windowed(port)
    sel, carries, out = list(lanes), None, []
    for s in range(STEPS):
        carries, dets = step(carries, torch.from_numpy(frames[s][sel]),
                             torch.from_numpy(sizes[s][sel]),
                             torch.from_numpy(RESETS[s][sel]))
        out.append(_to_numpy(carries, dets))
    return out


@pytest.fixture(scope="module")
def streams():
    model, params = _tiny_rdn()
    port = _port_rdn(params)
    frames, sizes = _frames()
    step = jax_engine.make_lockstep_step_windowed(model)
    # every lane resets on step 0, so the first carry's values are unread
    shapes = port._shapes()
    carries = RDNCarry(**{k: jnp.zeros((LANES, *shape), dtype=bool if dt == torch.bool
                                       else jnp.float32)
                          for k, (shape, dt) in shapes.items()})
    jax_out = []
    for s in range(STEPS):
        carries, dets = step(params, carries, jnp.asarray(frames[s][:, None]),
                             jnp.asarray(sizes[s][:, None]), jnp.asarray(RESETS[s]))
        jax_out.append((to_np(carries), to_np(dets)))
    return jax_out, _port_stream(port), port


def test_relation_attention_without_u_matches_jax():
    """RDN's attention has no ``u``: the JAX module's tree (which has none)
    loads strictly, and the port gives the JAX output per lane, with the
    position weight from pos_rois and some invalid refs."""
    rs = np.random.RandomState(3)
    lanes, n, m = 2, 7, 13
    x = rs.randn(lanes, n, 1024).astype(np.float32)
    refs = rs.randn(lanes, m, 1024).astype(np.float32)
    valid = rs.rand(lanes, m) > 0.3

    def boxes(k):
        xy = rs.rand(lanes, k, 2) * 60
        return np.concatenate([xy, xy + 4 + rs.rand(lanes, k, 2) * 30], -1).astype(
            np.float32)

    rois, ref_rois = boxes(n), boxes(m)
    jmod = JaxRelationAttention(use_position=True, use_u_bias=False)
    params = to_np(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x[0]), jnp.asarray(refs[0]),
                             jnp.asarray(valid[0]),
                             pos_rois=(jnp.asarray(rois[0]), jnp.asarray(ref_rois[0])))
                   ["params"])
    assert "u" not in params
    params = off_relu_corner(params)
    params["Wv_kernel"] = params["Wv_kernel"] * 3
    port = RelationAttention(use_u_bias=False)
    assert port.u is None
    port.load_state_dict(state_dict_from_flax(params), strict=True)
    with torch.inference_mode():
        got = port.eval()(torch.from_numpy(x), torch.from_numpy(refs),
                          torch.from_numpy(valid),
                          pos_rois=(torch.from_numpy(rois), torch.from_numpy(ref_rois)))
    want = jax.vmap(lambda a, b, c, r, rr: jmod.apply({"params": params}, a, b, c,
                                                      pos_rois=(r, rr)))(
        *(jnp.asarray(t) for t in (x, refs, valid, rois, ref_rois)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_rdn_extractor_advanced_stage_matches_jax():
    """``extract_test`` (2 base stages and the advanced stage) on random key
    features and window refs of 2 lanes, with the tiny RDN's extractor
    weights on both sides."""
    _, params = _tiny_rdn()
    c, v = TINY_C, TINY_V
    kw = dict(depth=c.depth, reduce_channel=c.reduce_channel, mlp_dim=c.mlp_dim,
              base_stage=v.base_stage, advanced_stage=v.advanced_stage,
              base_num=c.ref_post_nms_top_n,
              advanced_num=int(c.ref_post_nms_top_n * v.ratio))
    jext = JaxExtractor(**kw)
    eparams = params["extractor"]
    port = RDNFeatureExtractor(**kw).eval()
    port.load_state_dict(state_dict_from_flax(eparams), strict=True)
    rs = np.random.RandomState(5)
    lanes, k, m = 2, c.post_nms_top_n_test, v.all_frame_interval * c.ref_post_nms_top_n

    def boxes(count):
        xy = rs.rand(lanes, count, 2) * np.array([CANVAS[1], CANVAS[0]]) * 0.8
        return np.concatenate([xy, xy + 2 + rs.rand(lanes, count, 2) * 30], -1).astype(
            np.float32)

    x = np.abs(rs.randn(lanes, k, 1024)).astype(np.float32)
    feats = np.abs(rs.randn(lanes, m, 1024)).astype(np.float32)
    cur, refs = boxes(k), boxes(m)
    valid = rs.rand(lanes, m) > 0.2
    valid[1, : c.ref_post_nms_top_n] = False  # a frame with no valid ref
    args = (x, cur, refs, valid, feats)
    want = jax.vmap(lambda *a: jext.apply({"params": eparams}, *a,
                                          method=JaxExtractor.extract_test))(
        *(jnp.asarray(t) for t in args))
    with torch.inference_mode():
        got = port.extract_test(*(torch.from_numpy(t) for t in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL_CARRY)


@pytest.mark.parametrize("field", RDNCarry._fields)
def test_rdn_lockstep_carry_matches_jax_every_step(streams, field):
    jax_out, port_out, _ = streams
    for s, ((jc, _), (pc, _)) in enumerate(zip(jax_out, port_out)):
        atol = ATOL_BOX if field in BOX_FIELDS else ATOL_CARRY
        assert_field_close(getattr(jc, field), getattr(pc, field), atol,
                           f"{field} step {s}")


def test_rdn_lockstep_detections_match_jax(streams):
    jax_out, port_out, _ = streams
    matched = total = 0
    for (_, jd), (_, pd) in zip(jax_out, port_out):
        m, t = match_detections(jd, pd, LANES)
        matched, total = matched + m, total + t
    assert total > 0
    assert matched >= 0.95 * total, (matched, total)


def test_rdn_lane_equals_one_lane_step(streams):
    """Lane l of the 3-lane step equals the step on lane l's inputs alone,
    run as 3 copies of the lane and read at row l: the CPU convolutions and
    GEMMs round by batch size and row position (oneDNN takes another path
    for one frame), which the carry carries forward; the other lanes' data
    must not matter."""
    _, port_out, port = streams
    for lane in range(LANES):
        solo = _port_stream(port, lanes=(lane,) * LANES)
        for s, ((pc, pd), (sc, sd)) in enumerate(zip(port_out, solo)):
            for got, want in zip(leaves(pc) + list(pd), leaves(sc) + list(sd)):
                msg = f"lane {lane} step {s}"
                if want.dtype == np.float32:
                    np.testing.assert_allclose(got[lane], want[lane], rtol=0,
                                               atol=ATOL_LANE, err_msg=msg)
                else:  # masks, labels
                    np.testing.assert_array_equal(got[lane], want[lane], err_msg=msg)
