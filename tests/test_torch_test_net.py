"""The port's evaluation entry point end to end on ``tiny_root`` on the CPU:
``python -m mega_pytorch_tpu_torch.tools.test_net --device cpu`` with f32
tiny opts writes the predictions, ``result.txt`` and ``result.json``; its
predictions equal a direct ``compute_on_dataset`` call on the same seeded
model (exactly, in one process); ``test_prediction`` rescoring gives the same
result; without ``--device`` it takes the card and fails where there is
none."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mega_pytorch_tpu_torch.config import get_preset
from mega_pytorch_tpu_torch.data.loader import EvalPreprocessor
from mega_pytorch_tpu_torch.data.paths_catalog import build_dataset
from mega_pytorch_tpu_torch.engine.inference import compute_on_dataset
from mega_pytorch_tpu_torch.models.detectors import build_detection_model
from mega_pytorch_tpu_torch.tools import test_net, test_prediction
from test_torch_config import TINY_OPTS
from torch_port_harness import ilsvrc_data_dir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the tiny window of TINY_OPTS reads ahead one frame
OPTS = TINY_OPTS + ["MODEL.VID.MEGA.MAX_OFFSET", "1", "MODEL.VID.MEGA.MIN_OFFSET", "-1"]


def _args(data_dir, out, preset, lanes, device="cpu"):
    return (["--preset", preset, "--data-dir", str(data_dir), "--output-dir", str(out),
             "--lanes", str(lanes), "--seed", "3"]
            + (["--device", device] if device else []) + ["opts", *OPTS])


def _direct(data_dir, preset, lanes):
    """What test_net computes, called directly: the seeded model, the
    config's dataset and preprocessor, one shard."""
    cfg = get_preset(preset)
    cfg.merge_from_list(OPTS)
    method = cfg.MODEL.VID.METHOD if cfg.MODEL.VID.ENABLE else "base"
    model = build_detection_model(cfg, "cpu", torch.Generator("cpu").manual_seed(3), lanes)
    ds = build_dataset(cfg.DATASETS.TEST[0], method, data_dir=str(data_dir),
                       **test_net.dataset_kwargs(cfg, method, 3))
    prep = EvalPreprocessor(min_size=48, max_size=64, canvas_short=48, canvas_long=64,
                            max_gt=cfg.TPU.MAX_GT_BOXES)
    return ds, compute_on_dataset(model, ds, list(range(len(ds))), prep, method, lanes=lanes)


def _assert_same_predictions(got, want):
    assert sorted(got) == sorted(want) == list(range(10))
    for i in want:
        for k in ("boxes", "scores", "labels"):
            np.testing.assert_array_equal(got[i][k], want[i][k], err_msg=f"{i} {k}")


@pytest.mark.parametrize("preset,lanes", [("mega_R_50", 2), ("base_R_50", 1)])
def test_test_net_main_equals_compute_on_dataset(tiny_root, tmp_path, preset, lanes):
    """MEGA through the lockstep engine (2 lanes), base through the serial
    engine; the npz holds every frame once, the results are finite, and
    rescoring the npz reproduces them."""
    data_dir = ilsvrc_data_dir(tiny_root, tmp_path)
    out = tmp_path / "out"
    run = test_net.main(_args(data_dir, out, preset, lanes))
    ds, want = _direct(data_dir, preset, lanes)
    _assert_same_predictions(run["predictions"], want)
    saved = test_net.load_predictions([out / "predictions_0.npz"])
    _assert_same_predictions(saved, want)
    result = json.loads((out / "result.json").read_text())
    assert list(result) == ["all"] and np.isfinite(result["all"]["map"])
    assert "AP50 | motion=   all" in (out / "result.txt").read_text()
    again = test_prediction.main(["--preset", preset, "--data-dir", str(data_dir),
                                  "--predictions", str(out / "predictions_0.npz")])
    assert again["all"]["map"] == result["all"]["map"]
    np.testing.assert_array_equal(np.asarray(again["all"]["ap"], np.float64),
                                  np.asarray(result["all"]["ap"], np.float64))


def test_test_net_cli(tiny_root, tmp_path):
    """The module runs as a program with ``--device cpu``; without
    ``--device`` it takes the card, so here, with none, it fails."""
    data_dir = ilsvrc_data_dir(tiny_root, tmp_path)
    env = dict(os.environ, PYTHONPATH=ROOT)
    cmd = [sys.executable, "-m", "mega_pytorch_tpu_torch.tools.test_net"]
    proc = subprocess.run(cmd + _args(data_dir, tmp_path / "cli", "mega_R_50", 2), cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "AP50 | motion=   all" in proc.stdout
    for name in ("predictions_0.npz", "result.txt", "result.json", "log.txt"):
        assert (tmp_path / "cli" / name).exists(), name
    if torch.cuda.is_available():
        return
    proc = subprocess.run(cmd + _args(data_dir, tmp_path / "card", "mega_R_50", 2, None),
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0
    assert "no CUDA card" in proc.stderr
    assert not (tmp_path / "card" / "result.json").exists()
