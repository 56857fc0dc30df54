"""Training of RDN, FGFA and DFF in the port against the JAX package, on the
CPU in f32: each method's ``forward_train`` (the four losses and every
parameter's gradient against ``jax.grad`` of the JAX one), the gradients of
the flow warp and of FlowNetS, and RDN's attention stages, which serving
and training now share (``RDNFeatureExtractor._stages``).

The losses and gradients follow ``tests/test_torch_train_models.py``'s
protocol: take-all sampling (both samplers keep every eligible anchor and
proposal, so no random draw changes the losses), Wg's bias off the relu
floor for RDN, each leaf's gradient within max(2e-3, 5x how far a 1e-6
relative jitter of the parameters moves the JAX gradient), the median leaf
within 2e-2. DFF's ``Convolution5_scale`` is drawn nonzero (it starts at
zero), so that the scale map acts (``_perturb_flow``).

The warp's border: JAX clips a sample coordinate with ``jnp.clip``, whose
gradient is 1/2 at a coordinate exactly on a bound; the port clips the same
way (``ops/warp.py:_clip``), so the gradients agree there too, and
``test_bilinear_sample_border_ties_equal_jax`` places coordinates exactly on
every bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_pytorch_tpu.models.backbone import flownet as jax_flownet
from mega_pytorch_tpu.models.detectors.dff import GeneralizedRCNNDFF as JaxDFF
from mega_pytorch_tpu.models.detectors.fgfa import GeneralizedRCNNFGFA as JaxFGFA
from mega_pytorch_tpu.models.detectors.rdn import GeneralizedRCNNRDN as JaxRDN
from mega_pytorch_tpu.models.detectors.rdn import VidConfig as JaxVidConfig
from mega_pytorch_tpu.models.roi_heads.vid_extractors import (
    RDNFeatureExtractor as JaxExtractor,
)
from mega_pytorch_tpu.ops.warp import bilinear_sample as jax_bilinear_sample
from mega_pytorch_tpu.ops.warp import warp_by_flow as jax_warp_by_flow
from mega_pytorch_tpu.structures.image_list import ImageBatch
from mega_pytorch_tpu_torch.models.backbone import flownet
from mega_pytorch_tpu_torch.models.detectors.dff import GeneralizedRCNNDFF
from mega_pytorch_tpu_torch.models.detectors.fgfa import GeneralizedRCNNFGFA
from mega_pytorch_tpu_torch.models.detectors.rdn import GeneralizedRCNNRDN
from mega_pytorch_tpu_torch.models.roi_heads.vid_extractors import RDNFeatureExtractor
from mega_pytorch_tpu_torch.ops.warp import bilinear_sample, warp_by_flow
from mega_pytorch_tpu_torch.utils.bridge import state_dict_from_flax
from test_dff_fgfa import TINY_C as FLOW_C
from test_rdn import TINY_C as RDN_C
from test_rdn import TINY_V as RDN_V
from test_torch_flow_methods import _perturb_flow
from test_torch_train_models import (
    _compare,
    _flat_grads,
    _frames,
    _jax_gt,
    _jax_side,
    _port_gt,
    _port_train_model,
    _sizes,
)
from torch_port_harness import CANVAS, off_relu_corner, port_configs, to_np

torch.set_num_threads(4)

FGFA_V = JaxVidConfig(method="fgfa", ref_num=2)
DFF_V = JaxVidConfig(method="dff")
# the warp's gradients against JAX's: the same products, the scatter-adds
# of the gathers' backward summed in another order
WARP_ATOL = 1e-5
# FlowNetS's gradients against JAX's, relative to each leaf's largest: ten
# f32 convolutions forward and back, which XLA and PyTorch round
# differently (the forward agrees to FLOW_ATOL in test_torch_flow_methods)
FLOW_GRAD_RTOL = 1e-4


def _take_all(c):
    """The RPN batch above the anchor count, the ROI batch the proposal
    slots plus the ground-truth slots, every positive allowed."""
    return c._replace(rpn_batch_size=100000,
                      roi_batch_size=c.post_nms_top_n_train + c.max_gt_boxes,
                      roi_positive_fraction=1.0)


def _run(jax_cls, port_cls, c, v, frames, adjust=None):
    """Both methods' losses and gradients on one sample of ``frames``
    (cur first), compared leaf by leaf."""
    images = ImageBatch(jnp.asarray(frames), jnp.asarray(_sizes(len(frames))))
    losses, grads, movement, params = _jax_side(jax_cls(c=c, v=v), images, _jax_gt(),
                                                adjust)
    model = _port_train_model(port_cls, params, *port_configs(c, v))
    got = model(
        (torch.from_numpy(frames), torch.from_numpy(_sizes(len(frames)))), _port_gt(),
        torch.Generator().manual_seed(0))
    sum(got.values()).backward()
    _compare(losses, grads, movement, model, got)
    return model


@pytest.mark.parametrize("advanced_stage", [0, 1])
def test_rdn_forward_train_equals_jax(advanced_stage):
    """Tiny RDN (R-14, cur + 2 refs, 10 refs a frame, 2 base stages, with
    and without the advanced stage): losses and gradients, every frame's
    map carrying gradient into res5 and the backbone."""
    v = RDN_V._replace(advanced_stage=advanced_stage)
    model = _run(JaxRDN, GeneralizedRCNNRDN, _take_all(RDN_C), v,
                 _frames(np.random.RandomState(2), 1 + v.ref_num), off_relu_corner)
    n_attn = 2 if advanced_stage == 0 else 4
    assert all(model.extractor.attn(i).Wg.kernel.grad.abs().max() > 0
               for i in range(n_attn))


def test_fgfa_forward_train_equals_jax():
    """Tiny FGFA (R-14, cur + 2 refs): FlowNetS, the warp, the embedding net
    and the cosine-weighted aggregation under gradient."""
    model = _run(JaxFGFA, GeneralizedRCNNFGFA, _take_all(FLOW_C), FGFA_V,
                 _frames(np.random.RandomState(3), 3))
    assert model.flownet.flow_conv1.weight.grad.abs().max() > 0
    assert model.embednet.embed_conv1.weight.grad.abs().max() > 0


def test_dff_forward_train_equals_jax():
    """Tiny DFF (R-14, [cur, ref]): the backbone on the ref only, FlowNetS
    with its scale map, the warp, the single-frame heads."""
    model = _run(JaxDFF, GeneralizedRCNNDFF, _take_all(FLOW_C), DFF_V,
                 _frames(np.random.RandomState(4), 2),
                 lambda p: _perturb_flow(p, np.random.RandomState(6)))
    assert model.flownet.Convolution5_scale.weight.grad.abs().max() > 0


def test_warp_gradients_equal_jax():
    """``warp_by_flow``'s gradients into the maps and the flow, on random
    flows that leave the map on every side, against ``jax.grad``."""
    rs = np.random.RandomState(0)
    feats = rs.randn(3, 7, 10, 5).astype(np.float32)
    flow = (rs.randn(3, 7, 10, 2) * 4).astype(np.float32)
    cot = rs.randn(3, 7, 10, 5).astype(np.float32)

    def jax_loss(f, fl):
        return jnp.sum(jax.vmap(jax_warp_by_flow)(f, fl) * cot)

    want = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(feats), jnp.asarray(flow))
    f, fl = (torch.from_numpy(t).requires_grad_() for t in (feats, flow))
    (warp_by_flow(f, fl) * torch.from_numpy(cot)).sum().backward()
    for g, w in zip((f.grad, fl.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=WARP_ATOL)
    assert np.abs(fl.grad.numpy()).max() > 1e-2


def test_bilinear_sample_border_ties_equal_jax():
    """Coordinates exactly on the clip's bounds (0 and W - 1, 0 and H - 1),
    outside them, integral inside, and fractional: the gradients into the
    coordinates and the map equal JAX's; on a bound they are half of what
    ``torch.clamp``'s gradient would give (the tie of ``jnp.clip``)."""
    rs = np.random.RandomState(1)
    h, w = 6, 9
    feats = rs.randn(2, h, w, 3).astype(np.float32)
    xs = rs.uniform(-2, w + 1, (2, h, w)).astype(np.float32)
    ys = rs.uniform(-2, h + 1, (2, h, w)).astype(np.float32)
    xs[0, 0], ys[0, 1] = 0.0, 0.0
    xs[0, 2], ys[0, 3] = w - 1.0, h - 1.0
    xs[1, :, :3] = np.arange(3)
    ys[1, 0] = 2.0
    cot = rs.randn(2, h, w, 3).astype(np.float32)

    def jax_loss(f, x, y):
        return jnp.sum(jax.vmap(jax_bilinear_sample)(f, x, y) * cot)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (feats, xs, ys)))
    args = [torch.from_numpy(t).requires_grad_() for t in (feats, xs, ys)]
    (bilinear_sample(*args) * torch.from_numpy(cot)).sum().backward()
    for g, wnt in zip(args, want):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(wnt), rtol=0, atol=WARP_ATOL)

    # on the lower bound the gradient is half the one just inside it, where
    # the clip passes the coordinate through (torch.clamp's would be whole)
    inside = xs.copy()
    inside[0, 0] = 1e-6
    x_in = torch.from_numpy(inside).requires_grad_()
    (bilinear_sample(torch.from_numpy(feats), x_in, torch.from_numpy(ys))
     * torch.from_numpy(cot)).sum().backward()
    tie = np.asarray(want[1])[0, 0]
    np.testing.assert_allclose(tie, 0.5 * x_in.grad.numpy()[0, 0], rtol=0, atol=1e-5)
    assert np.abs(tie).max() > 1e-2


@pytest.mark.parametrize("method", ["dff", "fgfa"])
def test_flownet_gradients_equal_jax(method):
    """FlowNetS's gradients into every parameter and its input pair, for
    "dff" (with the scale map) and "fgfa", against ``jax.grad``, each leaf
    within FLOW_GRAD_RTOL of its largest value."""
    rs = np.random.RandomState(5)
    pair = rs.rand(2, *CANVAS, 6).astype(np.float32)
    jnet = jax_flownet.FlowNetS(method=method)
    params = _perturb_flow(to_np(jnet.init(jax.random.PRNGKey(0),
                                           jnp.asarray(pair))["params"]), rs)
    out_shape = (2, CANVAS[0] // 16, CANVAS[1] // 16)
    cots = [rs.randn(*out_shape, 2).astype(np.float32)]
    if method == "dff":
        cots.append(rs.randn(*out_shape, 1024).astype(np.float32))

    def jax_loss(p, x):
        out = jnet.apply({"params": p}, x)
        out = out if method == "dff" else (out,)
        return sum(jnp.sum(o * c) for o, c in zip(out, cots))

    gp, gx = jax.grad(jax_loss, argnums=(0, 1))(params, jnp.asarray(pair))
    port = flownet.FlowNetS(method)
    port.load_state_dict(state_dict_from_flax(params), strict=True)
    x = torch.from_numpy(pair).requires_grad_()
    out = port(x)
    out = out if method == "dff" else (out,)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(out, cots)).backward()
    want = dict(_flat_grads(gp), input=np.asarray(gx))
    got = dict({n: p.grad.numpy() for n, p in port.named_parameters()}, input=x.grad.numpy())
    assert want.keys() == got.keys()
    for name, wv in want.items():
        scale = max(np.abs(wv).max(), 1e-12)
        err = np.abs(got[name] - wv).max() / scale
        assert err < FLOW_GRAD_RTOL, (name, err)


@pytest.mark.parametrize("advanced_stage", [0, 1])
def test_rdn_stages_serving_equal_jax(advanced_stage):
    """Serving through the shared ``_stages``: ``extract_test`` on fc0
    features of a 3-frame window of 10 refs each (some invalid) against the
    JAX ``extract_test``, with and without the advanced stage."""
    rs = np.random.RandomState(7 + advanced_stage)
    t, bn, k, d = 3, 10, 6, 1024
    x = np.maximum(rs.randn(k, d), 0).astype(np.float32)
    refs = np.maximum(rs.randn(t * bn, d), 0).astype(np.float32)

    def boxes(n):
        xy = rs.rand(n, 2) * 60
        return np.concatenate([xy, xy + 4 + rs.rand(n, 2) * 30], -1).astype(np.float32)

    cur_rois, ref_rois = boxes(k), boxes(t * bn)
    valid = rs.rand(t * bn) > 0.2
    kw = dict(depth="R-14", base_stage=2, advanced_stage=advanced_stage, base_num=bn,
              advanced_num=2)
    jext = JaxExtractor(**kw)
    args = tuple(jnp.asarray(a) for a in (x, cur_rois, ref_rois, valid, refs))
    params = off_relu_corner(to_np(jext.init(jax.random.PRNGKey(3), *args,
                                             method=JaxExtractor.extract_test)["params"]))
    want = jext.apply({"params": params}, *args, method=JaxExtractor.extract_test)
    port = RDNFeatureExtractor(**kw).eval()
    # serving runs no res5 head and no fcs_0 here (the window holds fc0
    # features), so the JAX tree has neither
    missing, unexpected = port.load_state_dict(state_dict_from_flax(params), strict=False)
    assert not unexpected and all(n.startswith(("head.", "fcs_0.")) for n in missing)
    with torch.inference_mode():
        got = port.extract_test(*(torch.from_numpy(a)[None]
                                  for a in (x, cur_rois, ref_rois, valid, refs)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=0, atol=2e-4)
