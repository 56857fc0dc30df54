"""RDN R-101 C4 inference, one lane and one frame at a time.

Follows the published model (Scalsol/mega.pytorch ``vid_R_101_C4_RDN_1x``
on ``BASE_RCNN_4gpu``; Deng et al., "Relation Distillation Networks for
Video Object Detection", ICCV 2019) as the benchmark's configuration file
states it, reusing ``vid.py``'s backbone, res5, RPN, ROIAlign, attention
and detection post-processing. Weights are a flat dict ``P`` of float32
tensors under the port's names; ``c`` is the configuration file's dict;
``prec`` a ``Precision``.

A frame's entry is its 300 key proposals with their fc0 (``fcs_0``)
features; its refs are the first 75 of them. The key frame's proposals
attend to the window's refs through the base stages (``attn_0``,
``attn_1``, each stage after the first applying its fc first); the refs
distilled to each frame's first 15 attend to all refs (``attn_2``) and go
through ``fcs_2``; the key proposals then attend to the distilled refs
(``attn_3``). Every attention uses the log position weight and no ``u``
bias.

Departures from the paper, where mega.pytorch's code and the paper differ
(the reference follows the code), and the program's documented semantics:

- the refs keep their ``fcs_0`` features through the base stages: only the
  key proposals are updated there;
- the distillation takes each frame's first 15 refs in the RPN's NMS score
  order, not the top by an objectness of the relation module;
- the window of a lockstep lane: at a video's start every slot holds its
  first frame, later steps push the newest frame, the last frame repeats
  past the video's end (so the window of frame j holds frames
  clamp(j - key + i, 0, n - 1));
- Detectron's +1 box convention and greedy NMS order, as ``vid.py``.
"""

from __future__ import annotations

import torch

from . import params
from .vid import (Entry, anchors_for, attention, backbone, dense, detections, pool_flat,
                  proposals, res5, rpn)


def param_spec(c: dict) -> list:
    """[(name, shape, initialiser)] of RDN ``c``: ``params.param_spec``'s
    backbone, RPN, res5 and predictor, with RDN's head in place of the
    fc6 / fc7 box head: ``extractor.fcs_0`` .. ``fcs_{base + advanced - 1}``
    (fcs_0 on the flat 7x7x2048 ROI features) and ``extractor.attn_0`` ..
    ``attn_{base + advanced}``, each with the position weight and no ``u``."""
    a = c["attention"]
    dim = c["mlp_dim"]
    flat = 2048 * c["pooler_resolution"] ** 2
    head: list = []
    n_fc = a["base_stages"] + a["advanced_stages"]
    for i in range(n_fc):
        params._dense(head, f"extractor.fcs_{i}", dim, flat if i == 0 else dim)
    for i in range(n_fc + 1):
        params._attention(head, f"extractor.attn_{i}", dim, a["embed_dim"], a["groups"], True)
    head = [s for s in head if not s[0].endswith(".u")]
    base = [s for s in params.param_spec(c)  # method "rdn": no FlowNetS
            if not s[0].startswith(("extractor.fc6.", "extractor.fc7."))]
    first = next(i for i, s in enumerate(base) if s[0].startswith("predictor."))
    return base[:first] + head + base[first:]


def rdn_frame(img, size, P, c, prec) -> Entry:
    """A frame's window entry: its 300 key proposals and their fc0
    features (the refs are the first ``ref_post_nms_top_n``), and the res5
    map, kept until the frame's detection (for probe ROIs)."""
    c4 = backbone(img, P, c, prec)
    enh = res5(c4, P, "extractor", c, prec)
    obj, dl = rpn(c4, P, prec)
    anchors = anchors_for(c, c4.shape[2], c4.shape[3], c4.device)
    props = proposals(obj, dl, anchors, size, c["pre_nms_top_n_test"],
                      c["post_nms_top_n_test"], c["rpn_nms_thresh"])
    return Entry(props.boxes, props.valid, fc0(enh, props.boxes, P, c, prec), enh)


def fc0(enh, rois, P, c, prec):
    return torch.relu(dense(pool_flat(enh, rois, c), P, "extractor.fcs_0", prec))


def rdn_detect(key: Entry, window: list, size, P, c, prec, probe=None):
    """Detections at the key frame over the T window entries (oldest
    first), and the class probabilities (E, C) at ``probe`` ROIs (E, 4) of
    the key frame, or None. Probe ROIs join the key ROIs as extra query
    rows: every row attends on its own, so they change nothing else."""
    a = c["attention"]
    groups = a["groups"]
    bn = c["ref_post_nms_top_n"]
    an = int(bn * c["ratio"])
    r_rois, r_feats, r_valid = (torch.cat([getattr(e, f)[:bn] for e in window])
                                for f in ("rois", "feats", "valid"))

    def distill(x):
        return x.reshape(len(window), bn, *x.shape[1:])[:, :an].reshape(-1, *x.shape[1:])

    n_own = len(key.rois)
    rois, x = key.rois, key.feats
    if probe is not None:
        rois = torch.cat([rois, probe])
        x = torch.cat([x, fc0(key.enh, probe, P, c, prec)])
    base = a["base_stages"]
    for i in range(base):
        if i > 0:
            x = torch.relu(dense(x, P, f"extractor.fcs_{i}", prec))
        x = x + attention(x, r_feats, r_valid, P, f"extractor.attn_{i}", prec,
                          pos=(rois, r_rois), groups=groups)
    adv_rois, adv_feats, adv_valid = distill(r_rois), distill(r_feats), distill(r_valid)
    for i in range(base, base + a["advanced_stages"]):
        att = attention(adv_feats, r_feats, r_valid, P, f"extractor.attn_{i}", prec,
                        pos=(adv_rois, r_rois), groups=groups)
        adv_feats = torch.relu(dense(adv_feats + att, P, f"extractor.fcs_{i}", prec))
    last = base + a["advanced_stages"]
    x = x + attention(x, adv_feats, adv_valid, P, f"extractor.attn_{last}", prec,
                      pos=(rois, adv_rois), groups=groups)
    logits = dense(x, P, "predictor.cls_score", prec)
    deltas = dense(x, P, "predictor.bbox_pred", prec)
    dets = detections(logits[:n_own], deltas[:n_own], key.rois, key.valid, size, c)
    return dets, (torch.softmax(logits[n_own:], -1) if probe is not None else None)


def rdn_video(frame_fn, n_frames: int, frames: list, P, c, prec, probes=None) -> dict:
    """Detections of ``frames`` (ascending) of one lane's video of
    ``n_frames`` frames from its start, ``frame_fn(i)`` → (normalized NCHW
    frame (1, 3, H, W), size): the first frame fills the window, as the
    lane's reset does, and the window of frame j holds frames
    clamp(j - key + i, 0, n - 1) → {frame: (dets, class probabilities at
    ``probes[frame]`` ROIs or None)}."""
    t, k = c["all_frame_interval"], c["key_frame_location"]
    cache: dict = {}

    def entry(i):
        if i not in cache:
            img, size = frame_fn(i)
            cache[i] = (rdn_frame(img, size, P, c, prec), size)
        return cache[i]

    out = {}
    for j in frames:
        win = [entry(min(max(j - k + i, 0), n_frames - 1)) for i in range(t)]
        key, size = win[k]
        out[j] = rdn_detect(key, [e for e, _ in win], size, P, c, prec,
                            None if probes is None else probes.get(j))
        for i in [i for i in cache if i < j - k]:
            del cache[i]
    return out


__all__ = ["param_spec", "rdn_frame", "rdn_detect", "rdn_video"]
