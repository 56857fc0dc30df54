"""The port's frame-folder demo on the CPU: its ``FolderVideo`` samples
equal those of the repo's JAX-side ``tools/demo.py`` (the same frames, bit
for bit, for every method); ``main`` over 6 tiny JPEG frames writes 6
annotated frames of the input size, and its detections equal
``StreamingInferencer``'s on the same frames with the same seeded model
(exactly, in one process), the canvases packed as ``pack_factor`` says; the
video input and output go through OpenCV, and a missing OpenCV raises a
clear error."""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mega_pytorch_tpu_torch.config import get_preset
from mega_pytorch_tpu_torch.data.loader import eval_preprocessor
from mega_pytorch_tpu_torch.engine.batched_inference import _to_host
from mega_pytorch_tpu_torch.engine.inference import StreamingInferencer, _extract
from mega_pytorch_tpu_torch.models.detectors import build_detection_model
from mega_pytorch_tpu_torch.tools import demo
from test_torch_config import TINY_OPTS

torch.set_num_threads(2)

OPTS = TINY_OPTS + ["MODEL.VID.MEGA.MAX_OFFSET", "1"]
FRAMES, HW = 6, (48, 64)


def _frames(rs):
    """A bright box moving over a dark noisy background, uint8 RGB."""
    out = []
    for f in range(FRAMES):
        arr = (rs.rand(*HW, 3) * 60).astype(np.uint8)
        arr[12:36, 8 + 3 * f:28 + 3 * f] = 220
        out.append(arr)
    return out


def _write_folder(folder, frames):
    from PIL import Image

    folder.mkdir()
    for i, arr in enumerate(frames):
        Image.fromarray(arr).save(folder / f"{i:06d}.JPEG", quality=95)


def _jax_demo():
    """The repo's ``tools/demo.py`` (numpy and PIL at import; JAX only in
    its ``main``)."""
    path = Path(__file__).resolve().parents[1] / "tools" / "demo.py"
    spec = importlib.util.spec_from_file_location("jax_tools_demo", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("method", ["mega", "rdn", "fgfa", "dff", "base"])
def test_folder_video_samples_equal_jax(tmp_path, method):
    """Every frame's sample at max offset 2 and 3 global frames: the same
    keys (the JAX one's ``gt`` None aside), scalars and frames, the port's
    arrays equal to ``np.asarray`` of JAX's PIL images."""
    from PIL import Image

    folder = tmp_path / "frames"
    _write_folder(folder, _frames(np.random.RandomState(2)))
    port, ref = demo.FolderVideo(str(folder)), _jax_demo().FolderVideo(str(folder))
    assert (len(port), port.h0, port.w0) == (len(ref), ref.h0, ref.w0) == (FRAMES, *HW)
    for i in range(FRAMES):
        got, want = port.sample(i, 2, 3, method), ref.sample(i, 2, 3, method)
        assert want.pop("gt") is None
        assert got.keys() == want.keys(), i
        for key, w in want.items():
            if isinstance(w, list):
                assert len(got[key]) == len(w), (i, key)
                for a, b in zip(got[key], w):
                    np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"{i} {key}")
            elif isinstance(w, Image.Image):
                np.testing.assert_array_equal(got[key], np.asarray(w), err_msg=f"{i} {key}")
            else:
                assert got[key] == w, (i, key)


def _direct(preset, folder):
    """What the demo computes, called directly: the seeded model and the
    serial engine over the folder, with the config's preprocessor. Returns
    the channel counts the backbone was given and the predictions."""
    cfg = get_preset(preset)
    cfg.merge_from_list(OPTS)
    method = cfg.MODEL.VID.METHOD if cfg.MODEL.VID.ENABLE else "base"
    model = build_detection_model(cfg, "cpu", torch.Generator("cpu").manual_seed(0))
    channels = set()
    model.backbone.register_forward_pre_hook(lambda _, args: channels.add(args[0].shape[-1]))
    video = demo.FolderVideo(str(folder))
    ds = demo.VideoDataset(video, method, cfg)
    prep = eval_preprocessor(cfg)
    runner = StreamingInferencer(model, method, prep, ds)
    preds = {}
    for i in range(len(ds)):
        sample = prep(ds[i])
        preds[i] = _extract(_to_host(runner.step(sample)), sample["cur_size"][0], HW)
    return channels, preds


@pytest.mark.parametrize("preset", ["mega_R_50", "base_R_50"])
def test_demo_folder_writes_frames_and_equals_streaming(tmp_path, preset):
    from PIL import Image

    folder, out = tmp_path / "frames", tmp_path / "vis"
    _write_folder(folder, _frames(np.random.RandomState(0)))
    run = demo.main(["--preset", preset, "--input-folder", str(folder), "--output-folder",
                     str(out), "--device", "cpu", "--confidence-threshold", "0.0",
                     "opts", *OPTS])
    written = sorted(out.iterdir())
    assert [p.name for p in written] == [f"{i:06d}.jpg" for i in range(FRAMES)]
    for p in written:
        with Image.open(p) as im:
            assert im.size == HW[::-1]
    channels, want = _direct(preset, folder)
    assert channels == {48}  # s2d(4)-packed canvases: the stem pool's path
    assert sorted(run["predictions"]) == list(range(FRAMES))
    for i in range(FRAMES):
        for k in ("boxes", "scores", "labels"):
            np.testing.assert_array_equal(run["predictions"][i][k], want[i][k],
                                          err_msg=f"{i} {k}")
    assert sum(len(p["boxes"]) for p in want.values()) > 0


def test_demo_video_in_and_out(tmp_path):
    """An MJPG video through ``--video`` with ``--output-video``: the same
    frame count comes out, in both the folder and the video."""
    import cv2

    src = tmp_path / "clip.avi"
    writer = cv2.VideoWriter(str(src), cv2.VideoWriter_fourcc(*"MJPG"), 25.0, HW[::-1])
    for arr in _frames(np.random.RandomState(1)):
        writer.write(arr[:, :, ::-1])
    writer.release()
    out = tmp_path / "vis"
    run = demo.main(["--preset", "mega_R_50", "--video", str(src), "--output-folder",
                     str(out), "--output-video", str(tmp_path / "vis.avi"), "--device",
                     "cpu", "opts", *OPTS])
    assert sorted(run["predictions"]) == list(range(FRAMES))
    assert len(list(out.iterdir())) == FRAMES
    cap = cv2.VideoCapture(str(tmp_path / "vis.avi"))
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == FRAMES
    cap.release()


def test_demo_without_opencv_says_so(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # the import fails
    with pytest.raises(RuntimeError, match="need OpenCV"):
        demo.main(["--preset", "mega_R_50", "--video", str(tmp_path / "clip.avi"),
                   "--output-folder", str(tmp_path / "vis"), "--device", "cpu"])
    with pytest.raises(SystemExit):  # exactly one input
        demo.parse_args(["--output-folder", str(tmp_path)])
