"""Meta-architecture factory (counterpart of
``mega_pytorch_tpu/models/detectors/__init__.py``): a config tree → one of
the port's five detectors, and the methods' flagship configurations."""

from __future__ import annotations

import torch

from ...config import get_preset
from .dff import GeneralizedRCNNDFF
from .fgfa import GeneralizedRCNNFGFA
from .mega import GeneralizedRCNNMEGA, build_mega_flagship
from .rcnn import GeneralizedRCNN, RCNNConfig, seeded_flagship, seeded_training
from .rdn import GeneralizedRCNNRDN, VidConfig

METHODS = ("base", "rdn", "fgfa", "dff", "mega")

_DETECTION_META_ARCHITECTURES = {
    "GeneralizedRCNN": GeneralizedRCNN,
    "GeneralizedRCNNDFF": GeneralizedRCNNDFF,
    "GeneralizedRCNNFGFA": GeneralizedRCNNFGFA,
    "GeneralizedRCNNRDN": GeneralizedRCNNRDN,
    "GeneralizedRCNNMEGA": GeneralizedRCNNMEGA,
}

# the R-101 preset of each method (config/presets.py)
FLAGSHIP_PRESETS = {"base": "base_R_101", "rdn": "rdn_R_101", "fgfa": "fgfa_R_101",
                    "dff": "dff_R_101", "mega": "mega_R_101"}


def detection_model(cfg, device=None):
    """cfg (ConfigNode) → the detector's modules, weights not drawn (so the
    ``meta`` device serves to read names and shapes)."""
    arch = _DETECTION_META_ARCHITECTURES[cfg.MODEL.META_ARCHITECTURE]
    c = RCNNConfig.from_cfg(cfg)
    if arch is GeneralizedRCNN:
        return GeneralizedRCNN(c, device=device)
    return arch(c, VidConfig.from_cfg(cfg), device=device)


def build_detection_model(cfg, device="cuda", generator: torch.Generator | None = None,
                          lanes: int = 1):
    """cfg (ConfigNode) → the detector on ``device``, its weights drawn from
    ``generator`` (seed 0 if None) and cast to ``TPU.COMPUTE_DTYPE``, in
    eval mode; ``lanes`` is kept as ``model.lanes`` for the engines."""
    return seeded_flagship(detection_model(cfg, device), device, generator, lanes)


def build_training_model(cfg, device="cuda", generator: torch.Generator | None = None):
    """cfg (ConfigNode) → the detector of any of the five methods on
    ``device`` for training: weights drawn from ``generator`` (seed 0 if
    None) and kept in f32, the backbone frozen below
    ``MODEL.BACKBONE.FREEZE_CONV_BODY_AT``, everything else trainable
    (FlowNetS and the embedding net included, as the JAX ``param_labels``),
    in train mode."""
    return seeded_training(detection_model(cfg, device), device, generator)


def build_method_flagship(method: str, canvas_h: int, canvas_w: int, device="cuda",
                          generator: torch.Generator | None = None, lanes: int = 4):
    """``build_detection_model`` of the method's R-101 preset, bf16, each
    pooling the 2048-channel res5 map (no channel reduce, fc0 / fc6 100352
    wide), on the canvas ``canvas_h`` x ``canvas_w``:

    - base: the single-frame detector (``GeneralizedRCNN.forward_test``);
    - rdn: 2 base stages and 1 advanced stage, window 37 with the key at
      slot 18, 75 refs a frame and 15 of them distilled;
    - fgfa: window 19 with the key at slot 9, FlowNetS and the embedding net;
    - dff: FlowNetS with its scale map; the engine takes a key every
      ``key_interval`` frames;
    - mega: ``build_mega_flagship``, the JAX package's benchmarked MEGA
      (channel reduce on), so its measured cell stays the same model;
      ``build_detection_model(get_preset("mega_R_101"))`` is the preset's.

    RDN and MEGA take s2d(4)-packed frames (canvas_h/4, canvas_w/4, 48) in
    the lockstep engine; FGFA and DFF plain RGB canvases, whose FlowNetS
    reads full-resolution frames. ``lanes`` is the lockstep lane count (4 in
    the JAX package's ``tools/bench_methods.py``)."""
    if method not in FLAGSHIP_PRESETS:
        raise ValueError(f"unknown method {method!r}; one of {METHODS}")
    if method == "mega":
        return build_mega_flagship(canvas_h, canvas_w, device, generator, lanes)
    if canvas_h % 16 or canvas_w % 16:
        raise ValueError("canvas sides must be multiples of 16")
    cfg = get_preset(FLAGSHIP_PRESETS[method])
    cfg.TPU.CANVAS_HEIGHT, cfg.TPU.CANVAS_WIDTH = canvas_h, canvas_w
    cfg.MODEL.VID.ROI_BOX_HEAD.REDUCE_CHANNEL = False
    return build_detection_model(cfg, device, generator, lanes)


__all__ = ["METHODS", "build_detection_model", "build_mega_flagship",
           "build_method_flagship", "build_training_model", "detection_model",
           "GeneralizedRCNN",
           "GeneralizedRCNNDFF", "GeneralizedRCNNFGFA", "GeneralizedRCNNRDN",
           "GeneralizedRCNNMEGA", "RCNNConfig", "VidConfig"]
