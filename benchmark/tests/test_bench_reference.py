"""The plain references against the port on the CPU at tiny sizes: the
parameter lists, each layer on the same inputs, and whole runs of the
offline driver (detections over steps that include a reset, MEGA's global
frames and memory) judged by the cells' own limits."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_tiny import tiny_cell  # noqa: E402
from benchmark.drivers import offline_lockstep as ol  # noqa: E402
from benchmark.harness.spec import load_json  # noqa: E402
from benchmark.harness.weights import calibrated_weights, draw_frames  # noqa: E402
from benchmark.reference import ops, vid  # noqa: E402
from benchmark.reference.params import param_spec  # noqa: E402

SIZE = (60, 90)


@pytest.mark.parametrize("name", ["mega_r101", "fgfa_r101"])
def test_param_spec_is_the_ports_state_dict(name):
    from mega_pytorch_tpu_torch.models.detectors import detection_model

    c = load_json(ROOT / "benchmark" / "configs" / f"{name}.json")
    port = detection_model(ol.port_config(c), "meta").state_dict()
    spec = {n: tuple(s) for n, s, _ in param_spec(c)}
    assert spec == {n: tuple(t.shape) for n, t in port.items()}


@pytest.fixture(scope="module")
def mega():
    cell = tiny_cell("mega")
    P = calibrated_weights(cell.config, 3, "cpu", SIZE)
    model = ol.build_model(cell.config, P, 1, "cpu")
    frame = draw_frames(1, cell.config["canvas"], torch.Generator().manual_seed(1), "cpu")
    return cell.config, P, model, frame


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def test_layers_match_the_port(mega):
    from mega_pytorch_tpu_torch.data.transforms import normalize_u8_frames
    from mega_pytorch_tpu_torch.ops.roi_align import roi_align as port_roi_align

    c, P, model, frame = mega
    prec = ops.Precision()
    sz = torch.tensor([SIZE], dtype=torch.float32)
    with torch.no_grad():
        xp = normalize_u8_frames(ol.model_input("mega", frame), sz)
        xr = ops.normalize_frames(frame, [SIZE])
        c4p = model.backbone(xp)
        c4r = vid.backbone(xr, P, c, prec)
        assert _rel(c4p.permute(0, 3, 1, 2), c4r) < 1e-4
        obj_p, dl_p = model.rpn(c4p)
        obj_r, dl_r = vid.rpn(c4r, P, prec)
        assert _rel(obj_p[0], obj_r) < 1e-4 and _rel(dl_p[0], dl_r) < 1e-4
        enh_p = model.extractor.enhance_features(c4p)
        enh_r = vid.res5(c4r, P, "extractor", c, prec)
        assert _rel(enh_p.permute(0, 3, 1, 2), enh_r) < 1e-4
        e = vid.mega_frame(xr, SIZE, P, c, prec)
        rois = e.rois
        pooled_p = port_roi_align(enh_r.permute(0, 2, 3, 1), rois[None], 1 / 16, 2, 2)[0]
        assert _rel(pooled_p, ops.roi_align(enh_r, rois, 1 / 16, 2)) < 1e-5
        att = model.extractor.l_attn(0)
        ap = att(e.feats[None], e.feats[None], e.valid[None], pos_rois=(rois[None], rois[None]),
                 precise_bias=True)[0]
        ar = vid.attention(e.feats, e.feats, e.valid, P, "extractor.l_attn_0", prec,
                           pos=(rois, rois))
        assert _rel(ap, ar) < 1e-4
        g = model.extractor.g_attn(0)
        assert _rel(g(e.feats[None], e.feats[None], e.valid[None])[0],
                    vid.attention(e.feats, e.feats, e.valid, P, "extractor.g_attn_0", prec)) < 1e-5


def test_nms_keep_sets_match_the_port():
    from mega_pytorch_tpu_torch.ops.nms import nms

    g = torch.Generator().manual_seed(0)
    xy = torch.rand((400, 2), generator=g) * 200
    boxes = torch.cat([xy, xy + 10 + torch.rand((400, 2), generator=g) * 60], 1)
    keep_p, valid_p = nms(boxes[None], torch.zeros(1, 400), torch.ones(1, 400, dtype=torch.bool),
                          0.5, 100, presorted=True)
    ref = ops.greedy_nms(boxes, 0.5, 100)
    assert keep_p[0][valid_p[0]].tolist() == ref


def test_warp_matches_the_port():
    from mega_pytorch_tpu_torch.ops.warp import warp_by_flow

    g = torch.Generator().manual_seed(0)
    fmap = torch.randn((2, 5, 7, 9), generator=g)
    flow = torch.randn((2, 2, 7, 9), generator=g) * 3
    port = warp_by_flow(fmap.permute(0, 2, 3, 1), flow.permute(0, 2, 3, 1))
    assert _rel(port.permute(0, 3, 1, 2), vid.warp(fmap, flow)) < 1e-5


@pytest.mark.parametrize("method", ["mega", "fgfa"])
def test_driver_run_is_correct_on_the_cpu(method):
    """A whole run of the offline driver: detections of videos from their
    reset (MEGA: with global frames and memory) against the reference,
    within the cell's limits; the reference's float8 control outside them."""
    cell = tiny_cell(method)
    r = ol.Run(cell, 2 ** 31 + 7, "cpu")
    with torch.no_grad():
        r.setup(ol.max_steps(2.0, cell.settings))
        r.warm()
    w = r.window(1.0)
    with torch.no_grad():
        while not r.sample(w["first"]):
            r.one_step()
    r.release()
    picks = r.sample(w["first"])
    numbers = r.compare(picks, control=True)
    ok, _ = ol.compare.judge(numbers["program"], cell.settings["limits"])
    assert ok, numbers["program"]
    bad, _ = ol.compare.judge(numbers["control"], cell.settings["limits"])
    assert not bad, numbers["control"]
