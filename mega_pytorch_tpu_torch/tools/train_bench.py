"""What the training checks and tools share: ``chip_smoke.py``'s train
phases, ``tools/ddp_check.py`` and ``tools/profile_mfu.py --train`` start
from a seeded model with FrozenBN statistics calibrated on seeded frames,
and the two tools train on seeded synthetic samples."""

from __future__ import annotations

import numpy as np
import torch

from ..data.loader import TrainPreprocessor
from ..models.layers import FrozenBatchNorm2d


def calibrate_frozen_bn(model, frames):
    """Set every FrozenBN's statistics to the per-channel mean and variance
    of its input on ``frames`` (normalized NHWC), in one forward pass of the
    backbone and the res5 head, layer by layer (each hook sets its layer's
    statistics before the layer runs, so the next sees normalized inputs).
    The stand-in for the ImageNet-pretrained statistics the reference
    starts from: random weights under identity statistics grow the
    activations through R-101's 33 residual blocks to where the first
    losses are ~40 and the second SGD step overflows, in the JAX package as
    in the port (``tests/r101_identity_bn_witness.py``). The pass runs in
    train mode, where the bottlenecks call their norms (eval mode runs them
    folded into the convolutions); the model's mode is restored after, which
    folds the calibrated statistics into an eval model."""
    def calibrate(module, inputs):
        x = inputs[0].float()
        module.running_mean.copy_(x.mean((0, 2, 3)))
        module.running_var.copy_(x.var((0, 2, 3)).clamp_min(1e-5))
        module.refresh()

    hooks = [m.register_forward_pre_hook(calibrate) for m in model.modules()
             if isinstance(m, FrozenBatchNorm2d)]
    training = model.training
    try:
        with torch.no_grad():
            model.train()
            model.extractor.enhance_features(model.backbone(frames))
    finally:
        model.train(training)
        for h in hooks:
            h.remove()
    model.backbone.stem.refresh()
    return model


def calibration_frames(cfg, frame_hw, rs, device, count: int = 2) -> torch.Tensor:
    """``count`` seeded uint8 frames of ``frame_hw`` preprocessed as cfg's
    training preprocessing does (the resize correlates neighbouring pixels,
    which sets the activations' scale) → (count, H, W, 3) f32 on ``device``."""
    return torch.from_numpy(np.stack([
        _train_preprocessor(cfg, rs)._prep(rs.randint(0, 256, (*frame_hw, 3), dtype=np.uint8),
                                           False).image
        for _ in range(count)])).to(device)


def _train_preprocessor(cfg, rng: np.random.RandomState) -> TrainPreprocessor:
    return TrainPreprocessor(min_size=cfg.INPUT.MIN_SIZE_TRAIN[0],
                             max_size=cfg.INPUT.MAX_SIZE_TRAIN,
                             canvas_short=cfg.TPU.CANVAS_HEIGHT,
                             canvas_long=cfg.TPU.CANVAS_WIDTH, max_gt=cfg.TPU.MAX_GT_BOXES,
                             rng=rng)


def _ref_groups(cfg) -> dict:
    """{sample key: frame count} of the references a training sample of
    cfg's method carries (the datasets' train side)."""
    v = cfg.MODEL.VID
    method = v.METHOD if v.ENABLE else "base"
    if method == "mega":
        return {"ref_l": v.MEGA.REF_NUM_LOCAL, "ref_m": v.MEGA.REF_NUM_MEM,
                "ref_g": v.MEGA.REF_NUM_GLOBAL}
    if method in ("rdn", "fgfa"):
        return {"ref": getattr(v, method.upper()).REF_NUM}
    return {"ref": 1} if method == "dff" else {}


def synthetic_samples(cfg, frame_hw, rs, count: int = 4) -> list[dict]:
    """``count`` preprocessed training samples of cfg's method made of
    seeded uint8 frames of ``frame_hw`` (cur and the method's references:
    MEGA's local, memory and global refs, RDN's and FGFA's ``REF_NUM``,
    DFF's one) with 1-3 random boxes each, as ``train_batches`` yields
    them."""
    h, w = frame_hw
    prep = _train_preprocessor(cfg, np.random.RandomState(rs.randint(1 << 30)))

    def frames(n):
        return [rs.randint(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]

    samples = []
    for _ in range(count):
        n = rs.randint(1, 4)
        xy = rs.rand(n, 2) * [w - 200, h - 200]
        boxes = np.concatenate([xy, xy + 40 + rs.rand(n, 2) * 150], 1).astype(np.float32)
        sample = {"cur": frames(1)[0],
                  "gt": {"boxes": boxes, "labels": rs.randint(1, 31, n), "im_info": (h, w)}}
        sample.update({key: frames(k) for key, k in _ref_groups(cfg).items()})
        samples.append(prep(sample))
    return samples
