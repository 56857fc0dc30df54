"""The port's training loop on the CPU: the samplers, the datasets' train
side, ``train_batches`` and each method's ``assemble_inputs`` against the
JAX package's for the same ``RandomState`` (exact); ``do_train`` over tiny
MEGA with a checkpoint and a resume that restores the saved state bit for
bit; ``python -m mega_pytorch_tpu_torch.tools.train_net --device cpu``,
which without ``--device`` takes the card and fails where there is none;
``train_net`` for RDN, FGFA and DFF."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from mega_pytorch_tpu.data import samplers as jax_samplers
from mega_pytorch_tpu.data.datasets import vid as jax_vid
from mega_pytorch_tpu.data.loader import TrainPreprocessor as JaxTrainPreprocessor
from mega_pytorch_tpu.data.loader import train_batches as jax_train_batches
from mega_pytorch_tpu.engine.trainer import assemble_inputs as jax_assemble_inputs
from mega_pytorch_tpu_torch.config import get_preset
from mega_pytorch_tpu_torch.data import samplers
from mega_pytorch_tpu_torch.data.datasets import vid
from mega_pytorch_tpu_torch.data.loader import (
    EvalPreprocessor,
    TrainPreprocessor,
    train_batches,
)
from mega_pytorch_tpu_torch.engine.trainer import assemble_inputs, do_train
from mega_pytorch_tpu_torch.models.detectors import build_training_model
from mega_pytorch_tpu_torch.solver import make_lr_scheduler, make_optimizer
from mega_pytorch_tpu_torch.tools import train_net
from mega_pytorch_tpu_torch.utils.checkpoint import Checkpointer
from mega_pytorch_tpu_torch.utils.logger import setup_logger
from test_torch_config import TINY_OPTS
from test_torch_data import _assert_same
from torch_port_harness import dataset_args, remove_tmp_outputs  # noqa: F401 (autouse fixture)

torch.set_num_threads(4)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CLASSES = ("VIDDataset", "VIDRDNDataset", "VIDFGFADataset", "VIDDFFDataset",
            "VIDMEGADataset")
PREP = dict(min_size=48, max_size=64, canvas_short=48, canvas_long=64, max_gt=4)
# tiny training widths on top of TINY_OPTS (R-14, f32)
TRAIN_OPTS = TINY_OPTS + [
    "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", "64", "MODEL.RPN.POST_NMS_TOP_N_TRAIN", "16",
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "8", "TPU.MAX_GT_BOXES", "4",
    "INPUT.MIN_SIZE_TRAIN", "(48,)", "INPUT.MAX_SIZE_TRAIN", "64",
    "SOLVER.IMS_PER_BATCH", "1", "SOLVER.MAX_ITER", "2", "SOLVER.CHECKPOINT_PERIOD", "1",
    "DATASETS.TRAIN", "('VID_train_15frames',)",
]


@pytest.mark.parametrize("kw", [
    dict(dataset_len=23, group_ids=[0] * 23, batch_size=1, max_iter=60, seed=0),
    dict(dataset_len=23, group_ids=[i % 3 == 0 for i in range(23)], batch_size=2,
         max_iter=40, seed=5, start_iter=7),
    dict(dataset_len=30, group_ids=[0] * 30, batch_size=2, max_iter=25, seed=1,
         shard=1, num_shards=3),
])
def test_training_indices_equal_jax(kw):
    assert list(samplers.training_indices(**kw)) == list(jax_samplers.training_indices(**kw))


def _det_tree(root):
    """A DET-style image set of three stills, one without a box (dropped
    from training)."""
    (root / "Data" / "DET" / "d").mkdir(parents=True)
    (root / "Annotations" / "DET" / "d").mkdir(parents=True)
    rs = np.random.RandomState(0)
    for i, objs in enumerate(([("n02691156", 4, 6, 30, 40)], [],
                              [("n02084071", 10, 2, 50, 30), ("n02958343", 1, 1, 9, 9)])):
        Image.fromarray((rs.rand(48, 64, 3) * 255).astype(np.uint8)).save(
            root / "Data" / "DET" / "d" / f"{i}.JPEG")
        items = "".join(f"<object><name>{w}</name><bndbox><xmin>{a}</xmin><ymin>{b}</ymin>"
                        f"<xmax>{c}</xmax><ymax>{d}</ymax></bndbox></object>"
                        for w, a, b, c, d in objs)
        (root / "Annotations" / "DET" / "d" / f"{i}.xml").write_text(
            f"<annotation><size><height>48</height><width>64</width></size>{items}"
            "</annotation>")
    (root / "det.txt").write_text("d/0 1\nd/1 2\nd/2 3\n")
    return dict(image_set="DET_train", data_dir=str(root), img_dir=str(root / "Data" / "DET"),
                anno_path=str(root / "Annotations" / "DET"), img_index=str(root / "det.txt"))


@pytest.mark.parametrize("cls_name", _CLASSES)
def test_train_samples_equal_jax(tiny_root, tmp_path, cls_name):
    """Train-side samples of the video set and of DET stills (references as
    copies of cur, images without a box dropped), drawn by the same
    RandomState, and ``train_batches`` over them with the same flips."""
    for args in (dataset_args(tiny_root), _det_tree(tmp_path)):
        ds = getattr(vid, cls_name)(**args, is_train=True, rng=np.random.RandomState(3))
        ref = getattr(jax_vid, cls_name)(**args, is_train=True, rng=np.random.RandomState(3))
        assert ds.image_set_index == ref.image_set_index and len(ds) in (10, 2)
        for i in range(len(ds)):
            _assert_same(ds[i], ref[i], f"{cls_name}[{i}]")
        indices = list(samplers.training_indices(len(ds), [0] * len(ds), 1, max_iter=4))
        got = train_batches(ds, TrainPreprocessor(**PREP, rng=np.random.RandomState(1)),
                            iter(indices))
        want = jax_train_batches(ref, JaxTrainPreprocessor(**PREP, rng=np.random.RandomState(1)),
                                 iter(indices))
        _assert_same(list(got), list(want), f"{cls_name} batches")


@pytest.mark.parametrize("cls_name", _CLASSES)
def test_train_dataset_needs_rng(tiny_root, cls_name):
    """A training dataset refuses to draw its references without an explicit
    RandomState; the test side needs none."""
    with pytest.raises(ValueError, match="rng"):
        getattr(vid, cls_name)(**dataset_args(tiny_root), is_train=True)
    assert len(getattr(vid, cls_name)(**dataset_args(tiny_root))) > 0


def _tiny_cfg(**extra):
    cfg = get_preset("mega_R_50")
    cfg.merge_from_list(TRAIN_OPTS + [x for kv in extra.items() for x in kv])
    return cfg.freeze()


def _state(model, optimizer, scheduler):
    return (model.state_dict(), optimizer.state_dict()["state"], scheduler.state_dict())


def _assert_equal_states(got, want):
    for g, w in zip(got[:2], want[:2]):
        assert g.keys() == w.keys()
        for k in w:
            items = w[k].items() if isinstance(w[k], dict) else [(None, w[k])]
            for sub, t in items:
                other = g[k] if sub is None else g[k][sub]
                assert torch.equal(other, t), (k, sub)
    assert got[2]["last_epoch"] == want[2]["last_epoch"]


def test_do_train_checkpoint_and_resume(tiny_root, tmp_path):
    """Two iterations of tiny MEGA with a checkpoint each; finite losses,
    frozen stages and FrozenBN untouched, every trainable leaf moved. A
    fresh model, optimizer and scheduler restored from the first checkpoint
    equal the state saved there bit for bit, and training resumes from it."""
    cfg = _tiny_cfg()
    logger = setup_logger("test_torch_train", None)

    def setup(seed):
        model = build_training_model(cfg, "cpu", torch.Generator().manual_seed(seed))
        optimizer = make_optimizer(cfg, model)
        return model, optimizer, make_lr_scheduler(cfg, optimizer)

    def batches(start_iter):
        ds = vid.VIDMEGADataset(**dataset_args(tiny_root), is_train=True,
                                rng=np.random.RandomState(start_iter))
        return train_batches(ds, TrainPreprocessor(**PREP, rng=np.random.RandomState(0)),
                             samplers.training_indices(len(ds), [0] * len(ds), 1,
                                                       start_iter=start_iter, max_iter=2))

    model, optimizer, scheduler = setup(0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ckpt = Checkpointer(str(tmp_path / "ckpt"), logger)
    record = do_train(cfg, model, batches(0), optimizer, scheduler, ckpt, logger,
                      generator=torch.Generator().manual_seed(0), log_period=1)
    assert record["iteration"] == 2 and len(record["losses"]) == 2
    assert all(np.isfinite(v) for losses in record["losses"] for v in losses.values())
    params = dict(model.named_parameters())
    for name, value in model.state_dict().items():
        frozen = name not in params or not params[name].requires_grad
        assert torch.equal(value, before[name]) == frozen, name
    assert ckpt.last_checkpoint().endswith("model_final.pth")
    assert scheduler.last_epoch == 2

    saved = ckpt.load(str(tmp_path / "ckpt" / "model_0000001.pth"))
    model, optimizer, scheduler = setup(1)
    start = Checkpointer.restore(saved, model, optimizer, scheduler)
    assert start == 1
    _assert_equal_states(_state(model, optimizer, scheduler),
                         (saved["model"], saved["optimizer"]["state"], saved["scheduler"]))
    resumed = do_train(cfg, model, batches(start), optimizer, scheduler,
                       Checkpointer(str(tmp_path / "resumed"), logger), logger,
                       start_iter=start, generator=torch.Generator().manual_seed(0))
    assert resumed["iteration"] == 2 and len(resumed["losses"]) == 1
    assert scheduler.last_epoch == 2
    ignored = ckpt.load(ignore_optimizer=True)
    assert ignored["iteration"] == 0 and ignored["optimizer"] is None


def _train_tree(root, tmp_path):
    """A ``--data-dir`` whose ILSVRC2015 tree is ``tiny_root``, its index as
    ``VID_train_15frames.txt``."""
    ilsvrc = tmp_path / "datasets" / "ILSVRC2015"
    (ilsvrc / "ImageSets").mkdir(parents=True)
    for sub in ("Data", "Annotations"):
        (ilsvrc / sub).symlink_to(root / sub, target_is_directory=True)
    (ilsvrc / "ImageSets" / "VID_train_15frames.txt").write_text(
        (root / "ImageSets" / "val.txt").read_text())
    return tmp_path / "datasets"


def test_train_net_cli(tiny_root, tmp_path):
    """Two iterations through the program with ``--device cpu``; without
    ``--device`` it takes the card, so here, with none, it fails."""
    data_dir = _train_tree(tiny_root, tmp_path)
    env = dict(os.environ, PYTHONPATH=ROOT)
    cmd = [sys.executable, "-m", "mega_pytorch_tpu_torch.tools.train_net", "--preset",
           "mega_R_50", "--data-dir", str(data_dir)]
    out = tmp_path / "out"
    proc = subprocess.run(cmd + ["--output-dir", str(out), "--device", "cpu", "opts",
                                 *TRAIN_OPTS], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "iter: 2" in proc.stdout
    for name in ("model_0000001.pth", "model_0000002.pth", "model_final.pth",
                 "last_checkpoint", "config.yml", "log.txt"):
        assert (out / name).exists(), name
    # resume: the checkpoint holds iteration 2 = MAX_ITER, so nothing runs
    run = train_net.main(["--preset", "mega_R_50", "--data-dir", str(data_dir),
                          "--output-dir", str(out), "--device", "cpu", "--resume", "opts",
                          *TRAIN_OPTS])
    assert run["iteration"] == 2 and run["losses"] == []
    if torch.cuda.is_available():
        return
    proc = subprocess.run(cmd + ["--output-dir", str(tmp_path / "card"), "opts", *TRAIN_OPTS],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0
    assert "no CUDA card" in proc.stderr
    assert not (tmp_path / "card" / "model_final.pth").exists()


_METHOD_CLASSES = {"base": "VIDDataset", "rdn": "VIDRDNDataset", "fgfa": "VIDFGFADataset",
                   "dff": "VIDDFFDataset", "mega": "VIDMEGADataset"}


@pytest.mark.parametrize("method", list(_METHOD_CLASSES))
def test_assemble_inputs_equal_jax(tiny_root, method):
    """A preprocessed training sample of each method → the same frames, sizes
    and ground truth as the JAX ``assemble_inputs`` (its ImageBatch fields)."""
    ds = getattr(vid, _METHOD_CLASSES[method])(**dataset_args(tiny_root), is_train=True,
                                              rng=np.random.RandomState(2))
    sample = TrainPreprocessor(**PREP, rng=np.random.RandomState(3))(ds[4])
    got, got_gt = assemble_inputs(method, sample)
    want, want_gt = jax_assemble_inputs(method, sample)

    def fields(x):
        if isinstance(x, dict):
            return {k: fields(v) for k, v in x.items()}
        return tuple(x) if isinstance(x, tuple) else (x.tensors, x.sizes)

    _assert_same(fields(got), fields(want), method)
    _assert_same(got_gt, want_gt, method)
    frames = {"base": 1, "rdn": 3, "fgfa": 3, "dff": 2}.get(method)
    if frames:
        assert got[0].shape == (frames, 48, 64, 3) and got[1].shape == (frames, 2)


def test_train_preprocessor_needs_rng():
    """The training preprocessor refuses to draw its flips without an
    explicit RandomState; the evaluation one (no flips) needs none."""
    with pytest.raises(ValueError, match="rng"):
        TrainPreprocessor(**PREP)
    frame = (np.random.RandomState(0).rand(48, 64, 3) * 255).astype(np.uint8)
    out = EvalPreprocessor(**PREP)({"cur": frame, "gt": {
        "boxes": np.zeros((0, 4), np.float32), "labels": np.zeros(0, np.int64),
        "im_info": (48, 64)}})
    assert out["cur"].shape == (1, 48, 64, 3)


@pytest.mark.parametrize("preset, extra", [
    # the channel reduce keeps fc0 12544 wide (R-101's presets pool 2048
    # channels: 100352), and FGFA's and DFF's fc6 (100352 inputs) stays 64
    # wide, so that the checkpoints stay small
    ("rdn_R_101", ["SOLVER.IMS_PER_BATCH", "2", "MODEL.VID.ROI_BOX_HEAD.REDUCE_CHANNEL",
                   "True"]),
    ("fgfa_R_50", ["MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", "64"]),
    ("dff_R_50", ["MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", "64"]),
])
def test_train_net_methods(tiny_root, tmp_path, preset, extra):
    """``train_net --device cpu`` trains RDN (with the advanced stage, two
    samples an iteration in turn), FGFA and DFF at tiny widths: finite
    losses, a checkpoint every iteration, and against the seeded initial
    weights every trainable module moved (FlowNetS and the embedding net
    included), the frozen stem and layer1 and the FrozenBN statistics
    kept."""
    data_dir = _train_tree(tiny_root, tmp_path)
    out = tmp_path / "out"
    opts = TRAIN_OPTS + extra
    record = train_net.main(["--preset", preset, "--data-dir", str(data_dir), "--output-dir",
                             str(out), "--device", "cpu", "opts", *opts])
    assert record["iteration"] == 2
    assert all(np.isfinite(v) for losses in record["losses"] for v in losses.values())
    for name in ("model_0000001.pth", "model_0000002.pth", "model_final.pth"):
        assert (out / name).exists(), name
    cfg = get_preset(preset)
    cfg.merge_from_list(opts)
    initial = build_training_model(cfg, "cpu", torch.Generator().manual_seed(0))
    final = torch.load(out / "model_final.pth", weights_only=True)["model"]
    params = dict(initial.named_parameters())
    moved = {}
    for name, value in initial.state_dict().items():
        same = torch.equal(final[name], value)
        if name in params and params[name].requires_grad:
            top = name.split(".")[0] if not name.startswith("backbone.") else name[:15]
            moved[top] = moved.get(top, False) or not same
        else:
            assert same, name
    assert all(moved.values()) and len(moved) >= 5, moved
    if preset.startswith(("fgfa", "dff")):
        assert moved["flownet"] and moved.get("embednet", preset.startswith("dff"))
