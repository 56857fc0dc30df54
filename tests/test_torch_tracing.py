"""The port's spans and counters (``mega_pytorch_tpu_torch/utils/profiler.py``)
and the benchmark's readers of them.

* Off (no ``torch.profiler`` recording, outside ``recording()``): a whole
  tiny MEGA and FGFA lockstep step runs with ``record_function`` made to
  raise, and the recorder stores nothing.
* On, inside ``torch.profiler.profile``: the program's spans nest under the
  right parents with the right step index, and each shows by name in the
  exported Chrome trace.
* ``nms.rounds`` on chains of boxes, each overlapping the next above the
  threshold, equals the host rounds worked out by hand, on the peel path
  and on the chunked path.
* A new recording holds only its own stretch, after unrecorded calls.
* Spans opened on a second thread keep their own stack.
* The six readers of ``benchmark/metrics/`` on a synthetic summary, and
  ``None`` on an empty one or a program without the recorder.
* ``normalize_u8_frames`` builds its constant tensors once per device: a
  tensor made from host values is a copy that waits for the card, which
  the traced step counted as host syncs outside NMS.
"""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest
import torch

from benchmark.harness.spec import metric_reader
from mega_pytorch_tpu_torch.data import transforms
from mega_pytorch_tpu_torch.engine.batched_inference import (
    make_lockstep_step,
    make_lockstep_step_windowed,
    pack_frames,
)
from mega_pytorch_tpu_torch.models.detectors.fgfa import GeneralizedRCNNFGFA
from mega_pytorch_tpu_torch.models.detectors.mega import (
    GeneralizedRCNNMEGA,
    RCNNConfig,
    VidConfig,
)
from mega_pytorch_tpu_torch.models.detectors.rcnn import seeded_flagship
from mega_pytorch_tpu_torch.ops.nms import nms
from mega_pytorch_tpu_torch.utils import profiler

torch.set_num_threads(2)

LANES = 2
CANVAS = (64, 96)
TINY_C = dict(depth="R-14", anchor_sizes=(16, 32, 64), pre_nms_top_n_test=128,
              ref_pre_nms_top_n=64, ref_post_nms_top_n=10, detections_per_img=8,
              max_gt_boxes=4)
PROGRAM_SPANS = {
    # span: its parent in the step (MEGA, FGFA)
    "mega": {"lockstep_step": None, "precompute": "lockstep_step", "backbone": "precompute",
             "res5": "precompute", "rpn_postprocess": "precompute", "roi_align": "precompute",
             "carry": "lockstep_step", "detect_key": "lockstep_step",
             "nms": ("rpn_postprocess", "detect_key")},
    "fgfa": {"lockstep_step": None, "precompute": "lockstep_step", "backbone": "precompute",
             "carry": "lockstep_step", "detect_key": "lockstep_step",
             "flownet": "detect_key", "warp_by_flow": "detect_key", "res5": "detect_key",
             "rpn_postprocess": "detect_key", "roi_align": "detect_key",
             "nms": ("rpn_postprocess", "detect_key")},
}
READERS = ("nms_rounds_per_step.offline", "nms_span_ms_per_step.offline",
           "res5_ms_per_step.offline", "roi_align_ms_per_step.offline",
           "carry_ms_per_step.offline", "host_busy_ms_per_step.offline")


@pytest.fixture(scope="module")
def steps():
    """{method: run(n) → runs n lockstep steps of the tiny model}."""
    rs = np.random.RandomState(0)
    sizes = torch.tensor([list(map(float, CANVAS))] * LANES)
    on = torch.ones(LANES, dtype=torch.bool)
    frames = rs.randint(0, 256, (LANES, *CANVAS, 3), dtype=np.uint8)

    mega = seeded_flagship(GeneralizedRCNNMEGA(
        RCNNConfig(post_nms_top_n_test=24, **TINY_C),
        VidConfig(method="mega", base_stage=3, ratio=0.2, all_frame_interval=4,
                  key_frame_location=2, memory_size=3, global_size=2)), "cpu", None, LANES)
    mega_step = make_lockstep_step(mega)
    packed = torch.as_tensor(pack_frames("mega", frames))

    def run_mega(n):
        carries = mega.zero_carry(LANES, torch.device("cpu"))
        for s in range(n):
            carries, dets = mega_step(carries, packed, sizes, packed, sizes,
                                      on if s == 0 else ~on, on, on)
        return dets

    fgfa = seeded_flagship(GeneralizedRCNNFGFA(
        RCNNConfig(post_nms_top_n_test=16, **TINY_C),
        VidConfig(method="fgfa", all_frame_interval=5, key_frame_location=2)),
        "cpu", None, LANES)
    fgfa_step = make_lockstep_step_windowed(fgfa)
    plain = torch.as_tensor(frames)

    def run_fgfa(n):
        carries = None
        for s in range(n):
            carries, dets = fgfa_step(carries, plain, sizes, on if s == 0 else ~on)
        return dets

    return {"mega": run_mega, "fgfa": run_fgfa}


def _chain(n: int):
    """n boxes in score order, each overlapping the next at IoU 0.2 (+1
    areas) and no other: greedy NMS at 0.1 keeps every other box."""
    x = torch.arange(n, dtype=torch.float32) * 10.0
    boxes = torch.stack([x, torch.zeros(n), x + 14.0, torch.full((n,), 10.0)], -1)
    return boxes[None], torch.linspace(1.0, 0.5, n)[None], torch.ones(1, n, dtype=torch.bool)


@pytest.mark.parametrize("method", ["mega", "fgfa"])
def test_off_enters_no_record_function(steps, method, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered while the recorder is off")

    with profiler.recording():  # an empty stretch
        pass
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not profiler.enabled()
    dets = steps[method](2)
    assert torch.isfinite(dets.boxes).all()
    summary = profiler.recorded()
    assert summary["spans"] == {} and summary["counters"] == {} and summary["steps"] == 0
    assert summary["records"] == []


@pytest.mark.parametrize("method", ["mega", "fgfa"])
def test_on_spans_nest_and_show_in_the_trace(steps, method, tmp_path):
    with profiler.trace(str(tmp_path)):
        steps[method](2)
    summary = profiler.recorded()
    records = summary["records"]
    assert summary["steps"] == 2
    expected = PROGRAM_SPANS[method]
    assert set(summary["spans"]) == set(expected)
    for r in records:
        parent = None if r["parent"] is None else records[r["parent"]]
        want = expected[r["name"]]
        got = None if parent is None else parent["name"]
        assert got in (want if isinstance(want, tuple) else (want,)), (r["name"], got)
        assert r["step"] in (0, 1) and r["host_ms"] >= 0.0 and r["device_ms"] is None
        if parent is not None:
            assert parent["step"] == r["step"]
    assert [r["step"] for r in records if r["name"] == "lockstep_step"] == [0, 1]
    assert summary["spans"]["lockstep_step"]["calls"] == 2
    assert summary["spans"]["carry"]["calls"] == (4 if method == "mega" else 2)
    assert summary["counters"]["nms.rounds"] >= summary["spans"]["nms"]["calls"]
    assert summary["counters"]["host_wait"] > 0.0
    assert any(path.endswith("rpn_postprocess/nms") for path in summary["counters_by_span"])
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    shown = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert set(expected) <= shown


def test_nms_rounds_on_a_chain():
    """Peel path (7 boxes): each round keeps one box and removes the next,
    so rounds {0,1}, {2,3}, {4,5}, {6}, then the check that finds nothing
    left: 5. Chunked path (12 boxes, chunks of 4, 3 outputs): chunk 0's
    check, its peel ({0,1}, {2,3}, none left: 3), chunk 1's check, its peel
    ({4,5}, {6,7}, none left: 3; box 4 takes the third slot), chunk 2's
    check finds 3 kept and stops: 9."""
    with profiler.recording():
        keep_idx, keep_valid = nms(*_chain(7), 0.1, 8)
    assert keep_idx[0][keep_valid[0]].tolist() == [0, 2, 4, 6]
    summary = profiler.recorded()
    assert summary["counters"]["nms.rounds"] == 5
    assert summary["counters_by_span"]["nms"]["nms.rounds"] == 5
    assert summary["spans"]["nms"]["calls"] == 1

    with profiler.recording():
        keep_idx, keep_valid = nms(*_chain(12), 0.1, 3, chunk=4)
    assert keep_idx[0][keep_valid[0]].tolist() == [0, 2, 4]
    assert profiler.recorded()["counters"]["nms.rounds"] == 9


@pytest.mark.parametrize("how", ["recording", "torch_profiler"])
def test_a_new_recording_holds_only_its_own(how):
    def recorder():
        if how == "recording":
            return profiler.recording()
        return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])

    with recorder():
        nms(*_chain(7), 0.1, 8)
    assert profiler.recorded()["counters"]["nms.rounds"] == 5
    nms(*_chain(7), 0.1, 8)  # unrecorded
    nms(*_chain(7), 0.1, 8)
    assert profiler.recorded()["counters"]["nms.rounds"] == 5
    with recorder():
        nms(*_chain(3), 0.1, 8)  # {0,1}, {2}, none left
    summary = profiler.recorded()
    assert summary["counters"]["nms.rounds"] == 3
    assert summary["spans"]["nms"]["calls"] == 1 and len(summary["records"]) == 1


def test_threads_keep_their_own_stacks():
    opened, inner_done = threading.Event(), threading.Event()

    def worker():
        with profiler.annotate("t_outer", device=False):
            opened.set()
            inner_done.wait(10)
            with profiler.annotate("t_inner", device=False):
                profiler.count("t_count")

    with profiler.recording():
        with profiler.annotate("outer"):
            t = threading.Thread(target=worker)
            t.start()
            opened.wait(10)
            with profiler.annotate("inner"):
                profiler.count("m_count")
            inner_done.set()
            t.join(10)
    summary = profiler.recorded()
    records = summary["records"]
    parent = {r["name"]: (None if r["parent"] is None else records[r["parent"]]["name"])
              for r in records}
    assert parent == {"outer": None, "t_outer": None, "inner": "outer", "t_inner": "t_outer"}
    threads = {r["name"]: r["thread"] for r in records}
    assert threads["outer"] == threads["inner"] != threads["t_outer"] == threads["t_inner"]
    assert summary["counters_by_span"] == {"outer/inner": {"m_count": 1},
                                           "t_outer/t_inner": {"t_count": 1}}


def _summary(steps=4):
    spans = {"lockstep_step": {"calls": steps, "host_ms": 400.0, "device_ms": 480.0},
             "nms": {"calls": 12, "host_ms": 30.0, "device_ms": 58.0},
             "res5": {"calls": steps, "host_ms": 2.0, "device_ms": 28.0},
             "roi_align": {"calls": 12, "host_ms": 5.0, "device_ms": 88.0},
             "carry": {"calls": 2 * steps, "host_ms": 3.0, "device_ms": 10.0}}
    return {"steps": steps, "spans": spans, "counters": {"nms.rounds": 92, "host_wait": 36.0},
            "counters_by_span": {}, "records": []}


def test_the_readers(monkeypatch):
    ctx = {"trace": {"steps": 4}}
    want = {"nms_rounds_per_step.offline": 23.0, "nms_span_ms_per_step.offline": 14.5,
            "res5_ms_per_step.offline": 7.0, "roi_align_ms_per_step.offline": 22.0,
            "carry_ms_per_step.offline": 2.5, "host_busy_ms_per_step.offline": 91.0}
    monkeypatch.setattr(profiler, "recorded", _summary)
    assert {name: metric_reader(name)(ctx) for name in READERS} == want
    # a stretch without a span or counter leaves that metric out
    monkeypatch.setattr(profiler, "recorded", lambda: {
        **_summary(), "spans": {"nms": _summary()["spans"]["nms"]}, "counters": {}})
    got = {name: metric_reader(name)(ctx) for name in READERS}
    assert got == {name: (14.5 if name == "nms_span_ms_per_step.offline" else None)
                   for name in READERS}


@pytest.mark.parametrize("program", ["empty", "without_the_recorder"])
def test_the_readers_read_nothing(program, monkeypatch):
    if program == "empty":
        with profiler.recording():
            pass
    else:
        monkeypatch.delattr(profiler, "recorded")
    ctx = {"trace": {"steps": 6}}
    assert all(metric_reader(name)(ctx) is None for name in READERS)


@pytest.mark.parametrize("pack", [0, 2, 4])
def test_normalize_builds_its_constants_once(pack):
    frames = np.random.RandomState(pack).randint(0, 256, (2, *CANVAS, 3), dtype=np.uint8)
    packed = torch.as_tensor(transforms.s2d_pack_frames(frames, pack) if pack else frames)
    sizes = torch.tensor([[60.0, 90.0], [64.0, 80.0]])
    first = transforms.normalize_u8_frames(packed, sizes)
    key = (packed.device, tuple(float(m) for m in transforms.PIXEL_MEAN_BGR), packed.shape[-1])
    held = transforms._NORMALIZE_CONSTANTS[key]
    assert torch.equal(transforms.normalize_u8_frames(packed, sizes), first)
    assert all(a is b for a, b in zip(transforms._NORMALIZE_CONSTANTS[key], held))
    assert (held[1] is None) == (pack == 0)
