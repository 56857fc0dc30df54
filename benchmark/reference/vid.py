"""MEGA and FGFA R-101 C4 inference, one lane and one frame at a time.

Follows the published models (Scalsol/mega.pytorch: ``vid_R_101_C4_MEGA_1x``
and ``vid_R_101_C4_FGFA_1x`` on ``BASE_RCNN_4gpu``) as the benchmark's
configuration files state them. Weights are a flat dict ``P`` of float32
tensors under the port's names (``backbone.layer3.22.conv2.weight``); ``c``
is the configuration file's dict; ``prec`` a ``Precision``.

Departures, each the program's documented semantics: Detectron's +1 box
convention and greedy NMS order (ties broken by rank, a stable sort);
the window of a lockstep lane: at a video's start every slot holds its
first frame, later steps push the newest frame, the last frame repeats
past the video's end; MEGA's global frames are those the traffic names,
one a step (the first ``global_size`` while the window fills).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .ops import (Precision, cell_anchors, clip_boxes, decode, frozen_bn, greedy_nms,
                  grid_anchors, iou, roi_align)

STAGES = {"R-50": (3, 4, 6, 3), "R-101": (3, 4, 23, 3)}
NEG_INF = -1e30


# -- ResNet ---------------------------------------------------------------------

def _bottleneck(x, P, pre, stride, dilation, prec):
    s = 1 if dilation > 1 else stride  # the stride on the first 1x1
    if pre + "downsample_conv.weight" in P:
        idn = frozen_bn(prec.conv(x, P[pre + "downsample_conv.weight"],
                                  stride=stride if dilation == 1 else 1),
                        P, pre + "downsample_bn", prec)
    else:
        idn = x
    y = torch.relu(frozen_bn(prec.conv(x, P[pre + "conv1.weight"], stride=s),
                             P, pre + "bn1", prec))
    y = torch.relu(frozen_bn(prec.conv(y, P[pre + "conv2.weight"], padding=dilation,
                                       dilation=dilation), P, pre + "bn2", prec))
    y = frozen_bn(prec.conv(y, P[pre + "conv3.weight"]), P, pre + "bn3", prec)
    return torch.relu(y + idn)


def _stage(x, P, pre, blocks, stride, dilation, prec):
    for i in range(blocks):
        x = _bottleneck(x, P, f"{pre}.{i}.", stride if i == 0 else 1, dilation, prec)
    return x


def backbone(img, P, c, prec):
    """Normalized NCHW frames → the C4 map (N, 1024, H/16, W/16)."""
    y = prec.conv(img, P["backbone.stem.conv1.weight"], stride=2, padding=3)
    y = torch.relu(frozen_bn(y, P, "backbone.stem.bn1", prec))
    y = F.max_pool2d(y, 3, 2, 1)
    blocks = STAGES[c["depth"]]
    for i in range(3):
        y = _stage(y, P, f"backbone.layer{i + 1}", blocks[i], 1 if i == 0 else 2, 1, prec)
    return y


def res5(c4, P, prefix, c, prec):
    """Stage 5 on the whole C4 map: stride 1, dilation ``res5_dilation``."""
    return _stage(c4, P, prefix + ".head.layer4", STAGES[c["depth"]][3], 1,
                  c["res5_dilation"], prec)


# -- RPN and proposals --------------------------------------------------------------

@dataclass
class Proposals:
    boxes: torch.Tensor  # (K, 4)
    valid: torch.Tensor  # (K,)


def anchors_for(c, fh, fw, device):
    cell = cell_anchors(c["anchor_stride"], c["anchor_sizes"], c["aspect_ratios"])
    return torch.as_tensor(grid_anchors(fh, fw, c["anchor_stride"], cell), device=device)


def rpn(c4, P, prec):
    """One frame's C4 map (1, 1024, h, w) → objectness (h*w*A,), deltas
    (h*w*A, 4), in (y, x, anchor) order."""
    t = torch.relu(prec.conv(c4, P["rpn.conv.weight"], P["rpn.conv.bias"], padding=1))
    obj = prec.conv(t, P["rpn.cls_logits.weight"], P["rpn.cls_logits.bias"])
    dl = prec.conv(t, P["rpn.bbox_pred.weight"], P["rpn.bbox_pred.bias"])
    return obj[0].permute(1, 2, 0).reshape(-1), dl[0].permute(1, 2, 0).reshape(-1, 4)


def proposals(obj, deltas, anchors, size, pre_n, post_n, thresh) -> Proposals:
    """Sigmoid scores, the top ``pre_n`` (stable descending), decoded and
    clipped, greedy NMS to ``post_n``; short sets padded with the next
    suppressed candidates in rank order, invalid."""
    scores = torch.sigmoid(obj)
    order = torch.sort(scores, descending=True, stable=True).indices[:pre_n]
    boxes = decode(deltas[order], anchors[order], (1.0, 1.0, 1.0, 1.0))
    boxes = clip_boxes(boxes, float(size[0]), float(size[1]))
    keep = greedy_nms(boxes, thresh, post_n)
    valid = [True] * len(keep)
    if len(keep) < post_n:
        kept = set(keep)
        rest = [i for i in range(len(boxes)) if i not in kept][:post_n - len(keep)]
        keep, valid = keep + rest, valid + [False] * len(rest)
    idx = torch.tensor(keep, device=boxes.device)
    return Proposals(boxes[idx], torch.tensor(valid, device=boxes.device))


# -- ROI heads ------------------------------------------------------------------------

def pool_flat(fmap, rois, c):
    """ROIAlign of rois (R, 4) on an NCHW map → (R, res*res*C), (h, w, c) order."""
    res = c["pooler_resolution"]
    return roi_align(fmap, rois, c["pooler_scale"], res).reshape(len(rois), -1)


def dense(x, P, name, prec):
    return prec.linear(x, P[name + ".weight"], P[name + ".bias"])


def detections(logits, deltas, rois, valid, size, c) -> dict:
    """Softmax, per-class decode and clip, per-class greedy NMS over the
    classes' scores above the threshold, the top ``detections_per_img`` by
    score (stable; classes in order, each in its keep order); "candidates":
    how many survived the NMS before that cut."""
    probs = torch.softmax(logits, -1)
    boxes = clip_boxes(decode(deltas, rois, c["bbox_reg_weights"]),
                       float(size[0]), float(size[1]))
    k, nc = probs.shape
    boxes = boxes.reshape(k, nc, 4)
    out_b, out_s, out_l = [], [], []
    for cls in range(1, nc):
        s = probs[:, cls]
        ok = (s > c["score_thresh"]) & valid
        idx = torch.nonzero(ok).flatten()
        if len(idx) == 0:
            continue
        # ascending stable sort, reversed: equal scores high index first
        order = idx[torch.sort(s[idx], stable=True).indices.flip(0)]
        keep = order[greedy_nms(boxes[order, cls], c["nms_thresh"],
                                min(k, c["detections_per_img"]))]
        out_b.append(boxes[keep, cls])
        out_s.append(s[keep])
        out_l.append(torch.full((len(keep),), cls, device=s.device))
    if not out_s:
        z = logits.new_zeros((0,))
        return {"boxes": z.reshape(0, 4), "scores": z, "labels": z.long(), "candidates": 0}
    b, s, lab = torch.cat(out_b), torch.cat(out_s), torch.cat(out_l)
    top = torch.sort(s, descending=True, stable=True).indices[:c["detections_per_img"]]
    return {"boxes": b[top], "scores": s[top], "labels": lab[top], "candidates": len(s)}


# -- relation attention -----------------------------------------------------------------

def position_log_bias(rois, refs, wg, wb, prec, embed_dim=64):
    """log(relu(embedding(rois, refs) @ Wg + b) + 1e-6) → (g, N, M): the
    sinusoids of log |dx| / w, log |dy| / h, log w / w', log h / h' at the
    frequencies 100 / 1000^(f / (E/8)), rows (coordinate, sin|cos, freq)."""
    def geo(r):
        w = (r[:, 2] - r[:, 0] + 1.0).clamp_min(1e-3)
        h = (r[:, 3] - r[:, 1] + 1.0).clamp_min(1e-3)
        return w, h, 0.5 * (r[:, 0] + r[:, 2]), 0.5 * (r[:, 1] + r[:, 3])

    w, h, cx, cy = geo(rois.float())
    wr, hr, cxr, cyr = geo(refs.float())
    pos = torch.stack([
        torch.log(((cx[:, None] - cxr[None]) / w[:, None]).abs() + 1e-3),
        torch.log(((cy[:, None] - cyr[None]) / h[:, None]).abs() + 1e-3),
        torch.log(w[:, None] / wr[None]),
        torch.log(h[:, None] / hr[None])], -1)  # (N, M, 4)
    nf = embed_dim // 8
    freqs = 100.0 * torch.exp(-torch.arange(nf, device=rois.device, dtype=torch.float32)
                              / nf * math.log(1000.0))
    div = pos[..., None] * freqs
    emb = torch.stack([torch.sin(div), torch.cos(div)], -2).reshape(*pos.shape[:2], -1)
    pw = prec.einsum("nme,eg->gnm", emb, wg) + wb[:, None, None]
    return torch.log(pw.clamp_min(0.0) + 1e-6)


def attention(x, ref, ref_valid, P, name, prec, pos=None, groups=16):
    """Relation attention of queries x (N, D) over refs (M, D): per group,
    softmax((q.k + u.k) / sqrt(d) [+ log position weight]) over valid refs
    (all zero where none is valid) times the group's values, plus Wv's bias."""
    n, dim = x.shape
    m = ref.shape[0]
    d = dim // groups
    q = dense(x, P, name + ".Wq", prec).reshape(n, groups, d).transpose(0, 1)
    k = dense(ref, P, name + ".Wk", prec).reshape(m, groups, d).transpose(0, 1)
    v = prec.einsum("mf,gfd->gmd", ref, P[name + ".Wv_kernel"])
    aff = prec.einsum("gnd,gmd->gnm", q, k)
    if name + ".u" in P:
        aff = aff + prec.einsum("gd,gmd->gm", P[name + ".u"], k)[:, None, :]
    aff = aff / math.sqrt(d)
    if pos is not None:
        aff = aff + position_log_bias(pos[0], pos[1], P[name + ".Wg.kernel"],
                                      P[name + ".Wg.bias"], prec)
    aff = torch.where(ref_valid[None, None], aff, torch.full_like(aff, NEG_INF))
    w = torch.softmax(aff, -1) * ref_valid.any().float()
    out = prec.einsum("gnm,gmd->ngd", w, v).reshape(n, dim)
    return out + P[name + ".Wv_bias"]


# -- MEGA ---------------------------------------------------------------------------------

@dataclass
class Entry:
    """One frame's window entry: key proposals, their fc0 features; the
    first ``ref_post_nms_top_n`` of them are the frame's refs. ``enh``, the
    res5 map, is kept until the frame's detection (for probe ROIs)."""
    rois: torch.Tensor
    valid: torch.Tensor
    feats: torch.Tensor
    enh: torch.Tensor | None = None


def _frame_maps(img, P, c, prec):
    c4 = backbone(img, P, c, prec)
    return c4, res5(c4, P, "extractor", c, prec)


def mega_frame(img, size, P, c, prec, key: bool = True) -> Entry:
    """A frame's entry: ``key`` the 300 key proposals (the refs their first
    75), else the 75 ref proposals of a global frame."""
    c4, enh = _frame_maps(img, P, c, prec)
    obj, dl = rpn(c4, P, prec)
    anchors = anchors_for(c, c4.shape[2], c4.shape[3], c4.device)
    pre, post = ((c["pre_nms_top_n_test"], c["post_nms_top_n_test"]) if key
                 else (c["ref_pre_nms_top_n"], c["ref_post_nms_top_n"]))
    props = proposals(obj, dl, anchors, size, pre, post, c["rpn_nms_thresh"])
    return Entry(props.boxes, props.valid, fc0(enh, props.boxes, P, c, prec),
                 enh if key else None)


def fc0(enh, rois, P, c, prec):
    return torch.relu(dense(pool_flat(enh, rois, c), P, "extractor.l_fcs_0", prec))


def mega_detect(key: Entry, window: list, memory: list, glob: list, size, P, c, prec,
                probe=None):
    """Detections at the key frame, this frame's memory pushes, and the class
    probabilities (E, C) at ``probe`` ROIs (E, 4) of the key frame, or None.

    window: the T window entries (oldest first); memory: per stage a list of
    (rois, feats, valid) slots (oldest first); glob: (feats, valid) slots.
    Probe ROIs join the key ROIs as extra query rows: every row attends on
    its own, so they change nothing else."""
    a = c["attention"]
    bn = c["ref_post_nms_top_n"]
    an = int(bn * c["ratio"])
    w_rois = torch.cat([e.rois[:bn] for e in window])
    w_feats = torch.cat([e.feats[:bn] for e in window])
    w_valid = torch.cat([e.valid[:bn] for e in window])
    g_feats = torch.cat([g[0] for g in glob])
    g_valid = torch.cat([g[1] for g in glob])

    def distill(x):
        return x.reshape(len(window), bn, *x.shape[1:])[:, :an].reshape(-1, *x.shape[1:])

    def g_attn(x, i):
        return x + attention(x, g_feats, g_valid, P, f"extractor.g_attn_{i}", prec,
                             groups=a["groups"])

    n_own = len(key.rois)
    key_rois, key_feats = key.rois, key.feats
    if probe is not None:
        key_rois = torch.cat([key_rois, probe])
        key_feats = torch.cat([key_feats, fc0(key.enh, probe, P, c, prec)])
    n_key = len(key_rois)
    both = g_attn(torch.cat([key_feats, w_feats]), 0)
    x, x_ref = both[:n_key], both[n_key:]
    rois_dis, val_dis = distill(w_rois), distill(w_valid)
    cur_full = torch.cat([key_rois, rois_dis])
    feats = torch.cat([x, distill(x_ref)])
    pushes = []
    for i in range(a["stages"]):
        last = i == a["stages"] - 1
        if i == 0:
            refs, cur, n_push = (w_rois, x_ref, w_valid), cur_full, bn
        else:
            refs, cur, n_push = (rois_dis, feats[n_key:], val_dis), cur_full, an
            if last:
                cur, feats = key_rois, feats[:n_key]
        pushes.append(tuple(t[:n_push] for t in refs))  # the oldest frame's refs
        m_rois = torch.cat([refs[0]] + [s[0] for s in memory[i]])
        m_feats = torch.cat([refs[1]] + [s[1] for s in memory[i]])
        m_valid = torch.cat([refs[2]] + [s[2] for s in memory[i]])
        feats = feats + attention(feats, m_feats, m_valid, P, f"extractor.l_attn_{i}",
                                  prec, pos=(cur, m_rois), groups=a["groups"])
        if not last:
            feats = torch.relu(dense(feats, P, f"extractor.l_fcs_{i + 1}", prec))
    for i in range(c["global_res_stage"]):
        feats = g_attn(feats, i + 1)
    logits = dense(feats, P, "predictor.cls_score", prec)
    deltas = dense(feats, P, "predictor.bbox_pred", prec)
    dets = detections(logits[:n_own], deltas[:n_own], key.rois, key.valid, size, c)
    probs = torch.softmax(logits[n_own:], -1) if probe is not None else None
    return dets, pushes, probs


def mega_video(frame_fn, schedule, emit_upto: int, P, c, prec, probes=None) -> dict:
    """Detections of one lane's video from its start: ``schedule`` is the
    traffic's steps [(local frame, global frame or None, emitted frame or
    None)], ``frame_fn(i)`` → (normalized NCHW frame (1, 3, H, W), size).
    Runs the steps until frame ``emit_upto`` is emitted → {frame: (dets,
    class probabilities at ``probes[frame]`` ROIs or None)}."""
    a = c["attention"]
    t, s_mem, g_size = c["all_frame_interval"], c["memory_size"], c["global_size"]
    bn = c["ref_post_nms_top_n"]
    an = int(bn * c["ratio"])
    k = c["key_frame_location"]
    entries: dict = {}

    def entry(i):
        if i not in entries:
            img, size = frame_fn(i)
            entries[i] = (mega_frame(img, size, P, c, prec), size)
        return entries[i]

    window = memory = glob = None
    out = {}
    for s, (local, gidx, emit) in enumerate(schedule):
        e, size = entry(local)
        if s == 0:
            window = [e] * t
            dev, d = e.feats.device, e.feats.shape[1]
            memory = [[(torch.zeros(n, 4, device=dev), torch.zeros(n, d, device=dev),
                        torch.zeros(n, dtype=torch.bool, device=dev))] * s_mem
                      for n in [bn] + [an] * (a["stages"] - 1)]
            glob = [(torch.zeros(bn, d, device=dev),
                     torch.zeros(bn, dtype=torch.bool, device=dev))] * g_size
        else:
            window = window[1:] + [e]
        if gidx is not None:
            img, gsize = frame_fn(gidx)
            g = mega_frame(img, gsize, P, c, prec, key=False)
            glob = glob[1:] + [(g.feats, g.valid)]
        if emit is None:
            continue
        probe = None if probes is None else probes.get(emit)
        dets, pushes, probs = mega_detect(window[k], window, memory, glob, entry(emit)[1],
                                          P, c, prec, probe)
        memory = [m[1:] + [p] for m, p in zip(memory, pushes)]
        window[k].enh = None
        out[emit] = (dets, probs)
        if emit >= emit_upto:
            break
    return out


# -- FGFA -------------------------------------------------------------------------------------

_FLOW_ENC = (("flow_conv1", 7, 2), ("conv2", 5, 2), ("conv3", 5, 2), ("conv3_1", 3, 1),
             ("conv4", 3, 2), ("conv4_1", 3, 1), ("conv5", 3, 2), ("conv5_1", 3, 1),
             ("conv6", 3, 2), ("conv6_1", 3, 1))
_FLOW_DEC = (("Convolution1", "upsample_flow6to5", "deconv5", "conv5_1"),
             ("Convolution2", "upsample_flow5to4", "deconv4", "conv4_1"),
             ("Convolution3", "upsample_flow4to3", "deconv3", "conv3_1"),
             ("Convolution4", "upsample_flow3to2", "deconv2", "conv2"))


def flownet(pair, P, prec):
    """FlowNetS on (N, 6, H, W) frame pairs in [0, 1] → flow (N, 2, H/16, W/16)."""
    def lrelu(x):
        return F.leaky_relu(x, 0.1)

    def conv(x, name, k, s=1):
        return prec.conv(x, P[f"flownet.{name}.weight"], P[f"flownet.{name}.bias"],
                         stride=s, padding=k // 2)

    def crop(x, like):
        th, tw = like.shape[-2:]
        return x if x.shape[-2:] == like.shape[-2:] else x[:, :, 1:th + 1, 1:tw + 1]

    y = F.avg_pool2d(pair, 2, 2, ceil_mode=True)
    skips = {}
    for name, k, s in _FLOW_ENC:
        y = lrelu(conv(y, name, k, s))
        skips[name] = y
    for fconv, up, deconv, skip in _FLOW_DEC:
        target = skips[skip]
        flow = conv(y, fconv, 3)
        upf = crop(prec.conv_t(flow, P[f"flownet.{up}.weight"], P[f"flownet.{up}.bias"]),
                   target)
        dec = lrelu(crop(prec.conv_t(y, P[f"flownet.{deconv}.weight"],
                                     P[f"flownet.{deconv}.bias"]), target))
        y = torch.cat([target, dec, upf], 1)
    y = F.avg_pool2d(y, 2, 2, ceil_mode=True)
    return conv(y, "Convolution5", 3) * 2.5


def embednet(c4, P, prec):
    y = torch.relu(prec.conv(c4, P["embednet.embed_conv1.weight"], P["embednet.embed_conv1.bias"]))
    y = torch.relu(prec.conv(y, P["embednet.embed_conv2.weight"], P["embednet.embed_conv2.bias"],
                             padding=1))
    return prec.conv(y, P["embednet.embed_conv3.weight"], P["embednet.embed_conv3.bias"])


def warp(fmap, flow):
    """Backward bilinear warp of NCHW maps by flow (N, 2, h, w), the
    reference's ``grid_sample`` on (flow + identity) / ((size - 1) / 2) - 1,
    border padding."""
    n, _, h, w = fmap.shape
    ys = torch.arange(h, device=fmap.device, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=fmap.device, dtype=torch.float32)[None, :]
    gx = (xs + flow[:, 0]) / ((w - 1) / 2.0) - 1
    gy = (ys + flow[:, 1]) / ((h - 1) / 2.0) - 1
    return F.grid_sample(fmap, torch.stack([gx, gy], -1), mode="bilinear",
                         padding_mode="border", align_corners=False)


def fgfa_frame(img, P, c, prec):
    """A window entry: the frame's C4 map and its embedding (NCHW)."""
    c4 = backbone(img, P, c, prec)
    return c4, embednet(c4, P, prec)


def fgfa_detect(imgs: list, entries: list, size, P, c, prec, probe=None):
    """Detections of the key frame (the window's middle) from the window's
    normalized frames and entries (oldest first): each map and embedding
    warped to the key along FlowNetS's flow of (key / 255, frame / 255),
    softmaxed per-pixel cosine weights, the weighted sum through the
    single-frame heads → (dets, class probabilities at ``probe`` ROIs or None)."""
    k = c["key_frame_location"]
    ref_imgs = torch.cat(imgs)
    pair = torch.cat([imgs[k].expand_as(ref_imgs) / 255.0, ref_imgs / 255.0], 1)
    flow = flownet(pair, P, prec)
    feats = torch.cat([e[0] for e in entries])
    embeds = torch.cat([e[1] for e in entries])
    warped_f, warped_e = warp(feats, flow), warp(embeds, flow)
    cos = ((warped_e * warped_e[k:k + 1]).sum(1, keepdim=True)
           / ((warped_e.norm(dim=1, keepdim=True) + 1e-10)
              * (warped_e[k:k + 1].norm(dim=1, keepdim=True) + 1e-10)))
    agg = (torch.softmax(cos, 0) * warped_f).sum(0, keepdim=True)
    obj, dl = rpn(agg, P, prec)
    anchors = anchors_for(c, agg.shape[2], agg.shape[3], agg.device)
    props = proposals(obj, dl, anchors, size, c["pre_nms_top_n_test"],
                      c["post_nms_top_n_test"], c["rpn_nms_thresh"])
    enh = res5(agg, P, "extractor", c, prec)
    n_own = len(props.boxes)
    rois = props.boxes if probe is None else torch.cat([props.boxes, probe])
    x = torch.relu(dense(pool_flat(enh, rois, c), P, "extractor.fc6", prec))
    x = torch.relu(dense(x, P, "extractor.fc7", prec))
    logits = dense(x, P, "predictor.cls_score", prec)
    deltas = dense(x, P, "predictor.bbox_pred", prec)
    dets = detections(logits[:n_own], deltas[:n_own], props.boxes, props.valid, size, c)
    return dets, (torch.softmax(logits[n_own:], -1) if probe is not None else None)


def fgfa_video(frame_fn, n_frames: int, frames: list, P, c, prec, probes=None) -> dict:
    """Detections of ``frames`` of one video of ``n_frames`` frames: the
    window of frame j holds frames clamp(j - key + i, 0, n - 1) → {frame:
    (dets, class probabilities at ``probes[frame]`` ROIs or None)}."""
    t, k = c["all_frame_interval"], c["key_frame_location"]
    cache: dict = {}

    def entry(i):
        if i not in cache:
            img, size = frame_fn(i)
            cache[i] = (img, fgfa_frame(img, P, c, prec), size)
        return cache[i]

    out = {}
    for j in frames:
        idx = [min(max(j - k + i, 0), n_frames - 1) for i in range(t)]
        win = [entry(i) for i in idx]
        out[j] = fgfa_detect([w[0] for w in win], [w[1] for w in win], win[k][2], P, c, prec,
                             None if probes is None else probes.get(j))
        for i in [i for i in cache if i < j - k]:
            del cache[i]
    return out


def calibrate(imgs, P, c, prec_mode: str = "float32") -> dict:
    """FrozenBN statistics measured on normalized frames (N, 3, H, W) in one
    pass of the backbone and the res5 head: each layer's mean and variance
    of its input, set before the layer applies them."""
    stats: dict = {}
    prec = Precision(prec_mode, calibrate=stats)
    c4 = backbone(imgs, P, c, prec)
    res5(c4, P, "extractor", c, prec)
    return stats


__all__ = ["backbone", "calibrate", "fgfa_video", "mega_video", "mega_frame",
           "mega_detect", "fgfa_detect", "iou"]
