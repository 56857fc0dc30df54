"""RDN in the PyTorch port against the benchmark's plain reference
(``benchmark/reference/rdn.py``), on the CPU in float32 at a tiny size, with
seeded random weights (``benchmark/drivers/offline_rdn.py``'s draw and
FrozenBN calibration) loaded into the port's ``detection_model`` of the
``rdn_R_101`` preset cut to the tiny sizes:

* the reference's parameter list is the port's RDN state dict at the
  published widths (names and shapes);
* one frame's window entry equals the port's ``precompute``;
* the relation stages (``RDNFeatureExtractor._stages`` with the f32
  sinusoids of ``precise_bias``) and the predictor equal the reference's
  ``rdn_detect`` on a window of five distinct frames;
* two lanes of short videos, one reset mid-run, through
  ``make_lockstep_step_windowed`` give the reference's ``rdn_video``
  detections, judged as the benchmark judges them; the float8 control
  does not;
* the spans ``rdn_base`` and ``rdn_advanced`` are recorded once each per
  ``detect_key`` inside it, and not at all when nothing records;
* the reference imports no JAX and nothing of the port.
"""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "benchmark" / "tests"))

from bench_tiny_rdn import IMAGE_SIZE, tiny_rdn_config  # noqa: E402

from benchmark.drivers import offline_lockstep as ol  # noqa: E402
from benchmark.drivers import offline_rdn as od  # noqa: E402
from benchmark.harness import compare  # noqa: E402
from benchmark.harness.spec import load_json  # noqa: E402
from benchmark.harness.weights import draw_frames  # noqa: E402
from benchmark.reference import ops, rdn  # noqa: E402
from mega_pytorch_tpu_torch.data.transforms import normalize_u8_frames  # noqa: E402
from mega_pytorch_tpu_torch.engine.batched_inference import (  # noqa: E402
    make_lockstep_step_windowed,
)
from mega_pytorch_tpu_torch.utils import profiler  # noqa: E402

torch.set_num_threads(2)

LANES = 2
# the two lanes' videos: (first step, frames, first pool frame); lane 1
# resets at step 5 into its second video
VIDEOS = [[(0, 6, 0)], [(0, 3, 6), (5, 5, 9)]]
STEPS = 8
# The port's lockstep path computes the position bias with bf16 sinusoids
# (the JAX package's inference semantics; f32 only under ``precise_bias``),
# which moves each log position weight by ~3e-3 and the scores by ~0.5 %
# on average; the bounds leave twice that room. Box counts and the NMS are
# exact: a frame returns the top 50 of its several hundred candidates.
TF_GAP_MEAN, TF_GAP_P99, MISS_100_MEAN = 0.012, 0.045, 0.05
# f32 on both sides, the same sums in another order
REL_ENTRY, REL_PROBS = 1e-4, 1e-4


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()


@pytest.fixture(scope="module")
def tiny():
    """(configuration, weights, the port's model of ``LANES`` lanes, pool
    of uint8 canvases (16, H, W, 3))."""
    c = tiny_rdn_config()
    P = od.calibrated_weights(c, 5, "cpu", IMAGE_SIZE)
    model = ol.build_model(c, P, LANES, "cpu")
    pool = draw_frames(16, c["canvas"], torch.Generator().manual_seed(3), "cpu")
    return c, P, model, pool


def _ref_frame(pool, i):
    return ops.normalize_frames(pool[i][None], [IMAGE_SIZE]), IMAGE_SIZE


def test_param_spec_is_the_ports_state_dict():
    from mega_pytorch_tpu_torch.models.detectors import detection_model

    c = load_json(ROOT / "benchmark" / "configs" / "rdn_r101.json")
    port = detection_model(ol.port_config(c), "meta").state_dict()
    spec = {n: tuple(s) for n, s, _ in rdn.param_spec(c)}
    assert spec == {n: tuple(t.shape) for n, t in port.items()}
    assert spec["extractor.fcs_0.weight"] == (1024, 100352)
    assert not [n for n in spec if n.endswith(".u")]


def test_frame_entry_matches_precompute(tiny):
    c, P, model, pool = tiny
    sizes = torch.tensor([IMAGE_SIZE], dtype=torch.float32)
    with torch.no_grad():
        port = model.precompute(normalize_u8_frames(ol.model_input("rdn", pool[:1]), sizes),
                                sizes)
        ref = rdn.rdn_frame(*_ref_frame(pool, 0), P, c, ops.Precision())
    bn = c["ref_post_nms_top_n"]
    assert torch.equal(port["key_valid"][0], ref.valid)
    assert torch.allclose(port["key_rois"][0], ref.rois, atol=1e-3)
    assert _rel(port["key_feats"][0], ref.feats) < REL_ENTRY
    assert torch.equal(port["rois"][0], port["key_rois"][0, :bn])
    assert torch.equal(port["feats"][0], port["key_feats"][0, :bn])


def test_stages_match_the_reference(tiny):
    """The window of frames 0..4 (distinct), the key at slot 2: the port's
    stages with f32 sinusoids and predictor against the reference's class
    probabilities at the key's own proposals (as probe rows)."""
    c, P, model, pool = tiny
    prec = ops.Precision()
    k = c["key_frame_location"]
    bn = c["ref_post_nms_top_n"]
    with torch.no_grad():
        window = [rdn.rdn_frame(*_ref_frame(pool, i), P, c, prec)
                  for i in range(c["all_frame_interval"])]
        key = window[k]
        _, probs = rdn.rdn_detect(key, window, IMAGE_SIZE, P, c, prec, probe=key.rois)

        def refs(field):
            return torch.cat([getattr(e, field)[:bn] for e in window])[None]

        x = model.extractor._stages(key.feats[None], refs("feats"), key.rois[None],
                                    refs("rois"), refs("valid"), skip_first_fc=True,
                                    precise=True)
        logits, _ = model.predictor(x)
    assert _rel(torch.softmax(logits[0].float(), -1), probs) < REL_PROBS


def _schedule():
    """Per step, per lane: (pool frame, reset, (video, emitted frame) or None)."""
    warmup = 2  # window 5, key slot 2
    plan = []
    for s in range(STEPS):
        row = []
        for lane in VIDEOS:
            vi, (start, n, first) = max((v for v in enumerate(lane) if v[1][0] <= s),
                                        key=lambda v: v[1][0])
            j = s - start
            row.append((first + min(j, n - 1), j == 0,
                        (vi, j - warmup) if warmup <= j < warmup + n else None))
        plan.append(row)
    return plan


def _program_run(model, pool):
    """{(lane, video): {frame: valid detections}} of the lockstep step."""
    step = make_lockstep_step_windowed(model)
    packed = ol.model_input("rdn", pool)
    sizes = torch.tensor([IMAGE_SIZE] * LANES, dtype=torch.float32)
    carries, out = None, {}
    for row in _schedule():
        frames = packed[torch.tensor([r[0] for r in row])]
        resets = torch.tensor([r[1] for r in row])
        carries, dets = step(carries, frames, sizes, resets)
        for lane, (_, _, emit) in enumerate(row):
            if emit is not None:
                ok = dets.valid[lane]
                out.setdefault((lane, emit[0]), {})[emit[1]] = {
                    "boxes": dets.boxes[lane][ok], "scores": dets.scores[lane][ok],
                    "labels": dets.labels[lane][ok]}
    return out


def _judge(c, P, pool, program, mode):
    """compare.run_stats of ``mode``'s detections (the program's where
    ``mode`` is None) against the float32 reference."""
    triples = []
    for (lane, vi), frames in sorted(program.items()):
        _, n, first = VIDEOS[lane][vi]

        def frame_fn(i, first=first):
            return _ref_frame(pool, first + i)

        side = frames
        if mode is not None:
            side = {f: d for f, (d, _) in rdn.rdn_video(frame_fn, n, sorted(frames), P, c,
                                                         ops.Precision(mode)).items()}
        probes = {f: d["boxes"] for f, d in side.items()}
        ref = rdn.rdn_video(frame_fn, n, sorted(frames), P, c, ops.Precision(), probes)
        triples += [(side[f], ref[f][1], ref[f][0]) for f in sorted(frames)]
    return compare.run_stats(triples, c["nms_thresh"])


def test_lockstep_video_matches_the_reference(tiny):
    c, P, model, pool = tiny
    with torch.no_grad():
        program = _program_run(model, pool)
        assert sorted(program) == [(0, 0), (1, 0), (1, 1)]
        assert sum(map(len, program.values())) == 6 + 3 + 1
        got = _judge(c, P, pool, program, None)
        control = _judge(c, P, pool, program, "float8")
    assert got["count_gap_max"] == 0 and got["nms_excess_max"] <= 1e-5, got
    assert got["tf_gap_mean"] <= TF_GAP_MEAN and got["tf_gap_p99"] <= TF_GAP_P99, got
    assert got["miss_100_mean"] <= MISS_100_MEAN, got
    assert (control["tf_gap_mean"] > TF_GAP_MEAN or control["tf_gap_p99"] > TF_GAP_P99
            or control["miss_100_mean"] > MISS_100_MEAN), control


def _two_steps(model, pool):
    step = make_lockstep_step_windowed(model)
    frames = ol.model_input("rdn", pool[:LANES])
    sizes = torch.tensor([IMAGE_SIZE] * LANES, dtype=torch.float32)
    carries = None
    for s in range(2):
        carries, _ = step(carries, frames, sizes, torch.full((LANES,), s == 0))


def test_spans_once_per_detect_key(tiny):
    _, _, model, pool = tiny
    with profiler.recording():
        _two_steps(model, pool)
    summary = profiler.recorded()
    records = summary["records"]
    assert summary["spans"]["detect_key"]["calls"] == 2
    for name in ("rdn_base", "rdn_advanced"):
        assert summary["spans"][name]["calls"] == 2
        for r in records:
            if r["name"] == name:
                assert records[r["parent"]]["name"] == "detect_key"
    assert [r["step"] for r in records if r["name"] == "rdn_base"] == [0, 1]


def test_spans_off_when_nothing_records(tiny, monkeypatch):
    _, _, model, pool = tiny

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered while the recorder is off")

    with profiler.recording():  # an empty stretch
        pass
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _two_steps(model, pool)
    assert profiler.recorded()["spans"] == {}


def test_the_reference_loads_no_jax_and_nothing_of_the_port():
    probe = ("import sys; sys.path.insert(0, {root!r}); import benchmark.reference.rdn; "
             "print(','.join(sorted({{m.split('.')[0] for m in sys.modules}})))")
    out = subprocess.run([sys.executable, "-c", probe.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(out.stdout.strip().splitlines()[-1].split(","))
    assert "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "mega_pytorch_tpu", "mega_pytorch_tpu_torch"}
    tree = ast.parse((ROOT / "benchmark" / "reference" / "rdn.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module != "__future__":
            assert node.level == 1, node.module  # the references' own modules only
        elif isinstance(node, ast.Import):
            assert [a.name for a in node.names] == ["torch"]
