"""The detectors' flagship configurations (counterparts of the JAX
package's R-101 presets ``base_R_101``, ``rdn_R_101``, ``fgfa_R_101``,
``dff_R_101`` and of its ``build_mega_flagship``)."""

from __future__ import annotations

import torch

from .dff import GeneralizedRCNNDFF
from .fgfa import GeneralizedRCNNFGFA
from .mega import build_mega_flagship
from .rcnn import GeneralizedRCNN, RCNNConfig, seeded_flagship
from .rdn import GeneralizedRCNNRDN, VidConfig

METHODS = ("base", "rdn", "fgfa", "dff", "mega")


def build_method_flagship(method: str, canvas_h: int, canvas_w: int, device="cuda",
                          generator: torch.Generator | None = None, lanes: int = 4):
    """R-101 C4 in bf16 with the method preset's hyperparameters, every
    preset pooling the 2048-channel res5 map (no channel reduce, fc0 / fc6
    100352 wide), weights drawn on ``device`` from ``generator``:

    - base: the single-frame detector (``GeneralizedRCNN.forward_test``);
    - rdn: 2 base stages and 1 advanced stage, window 37 with the key at
      slot 18, 75 refs a frame and 15 of them distilled;
    - fgfa: window 19 with the key at slot 9, FlowNetS and the embedding net;
    - dff: FlowNetS with its scale map; the engine takes a key every
      ``key_interval`` frames;
    - mega: ``build_mega_flagship``.

    RDN and MEGA take s2d(4)-packed frames (canvas_h/4, canvas_w/4, 48);
    FGFA and DFF plain RGB canvases, whose FlowNetS reads full-resolution
    frames. ``lanes`` is the lockstep lane count (4 in the JAX package's
    ``tools/bench_methods.py``), kept as ``model.lanes``. Returns the model
    in eval mode."""
    if canvas_h % 16 or canvas_w % 16:
        raise ValueError("canvas sides must be multiples of 16")
    if method == "mega":
        return build_mega_flagship(canvas_h, canvas_w, device, generator, lanes)
    c = RCNNConfig(depth="R-101", compute_dtype="bfloat16", reduce_channel=False)
    if method == "base":
        model = GeneralizedRCNN(c, device=device)
    elif method == "rdn":
        model = GeneralizedRCNNRDN(c, VidConfig(method="rdn", advanced_stage=1),
                                   device=device)
    elif method == "fgfa":
        model = GeneralizedRCNNFGFA(c, VidConfig(method="fgfa", all_frame_interval=19,
                                                 key_frame_location=9), device=device)
    elif method == "dff":
        model = GeneralizedRCNNDFF(c, VidConfig(method="dff"), device=device)
    else:
        raise ValueError(f"unknown method {method!r}; one of {METHODS}")
    return seeded_flagship(model, device, generator, lanes)
