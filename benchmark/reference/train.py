"""MEGA R-101 C4 training, plain: one sample's four losses and an SGD step.

The published recipe (``BASE_RCNN_4gpu``: IMS_PER_BATCH 4, SGD momentum 0.9,
weight decay 1e-4, biases at twice the rate and no decay, a linear warmup
from a third over 500 iterations; RPN 256 anchors at half positives, 6000
→ 300 training proposals with the ground truth added, 128 ROIs at a
quarter positives) on the port's sample layout: a sample is cur + 2 local
frames, 3 memory frames (no gradient) and 2 global frames.

The random draws follow the program's order on one ``torch.Generator``
per sample's rank: the RPN sampler's (2, anchors) uniforms, then the ROI
sampler's (2, proposals) uniforms and (proposals,) tiebreaks. Products
run at ``prec`` (float32, or float8 operands with a straight-through
gradient for the control)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import vid
from .ops import Precision

BELOW, BETWEEN = -1, -2


class STPrecision(Precision):
    """Float8 operands in the forward pass, the identity in the backward."""

    def q(self, x):
        x = x.float()
        if self.mode == "float32":
            return x
        return x + (super().q(x.detach()) - x.detach())


def encode(gt, boxes, weights):
    ew = (boxes[:, 2] - boxes[:, 0] + 1.0).clamp_min(1e-6)
    eh = (boxes[:, 3] - boxes[:, 1] + 1.0).clamp_min(1e-6)
    ex, ey = boxes[:, 0] + 0.5 * (boxes[:, 2] - boxes[:, 0] + 1.0), \
        boxes[:, 1] + 0.5 * (boxes[:, 3] - boxes[:, 1] + 1.0)
    gw = (gt[:, 2] - gt[:, 0] + 1.0).clamp_min(1e-6)
    gh = (gt[:, 3] - gt[:, 1] + 1.0).clamp_min(1e-6)
    gx, gy = gt[:, 0] + 0.5 * (gt[:, 2] - gt[:, 0] + 1.0), gt[:, 1] + 0.5 * (gt[:, 3] - gt[:, 1] + 1.0)
    wx, wy, ww, wh = weights
    return torch.stack([wx * (gx - ex) / ew, wy * (gy - ey) / eh,
                        ww * torch.log(gw / ew), wh * torch.log(gh / eh)], 1)


def match(iou, gt_valid, high, low, low_quality):
    """iou (G, N) → (N,) ground-truth index, BELOW or BETWEEN."""
    q = torch.where(gt_valid[:, None], iou, torch.full_like(iou, -1.0))
    vals, idx = q.max(0)
    m = torch.where(vals < low, torch.full_like(idx, BELOW),
                    torch.where(vals < high, torch.full_like(idx, BETWEEN), idx))
    if low_quality:
        best = q.max(1, keepdim=True).values
        hit = ((q == best) & gt_valid[:, None] & (best > -1.0)).any(0)
        m = torch.where(hit, idx, m)
    return m


def balanced(labels, batch, fraction, gen):
    """(pos, neg) masks: the candidates of each class ranked by one uniform
    key each, kept below the class's budget."""
    u = torch.rand((1, 2, labels.shape[0]), generator=gen, device=labels.device)[0]
    pos, neg = labels >= 1, labels == 0
    n_pos = min(int(pos.sum()), int(batch * fraction))
    n_neg = min(int(neg.sum()), batch - n_pos)

    def take(mask, key, n):
        order = torch.argsort(torch.where(mask, key, torch.full_like(key, float("inf"))),
                              stable=True)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(len(order), device=order.device)
        return mask & (rank < n)
    return take(pos, u[0], n_pos), take(neg, u[1], n_neg)


def smooth_l1(x, t, beta):
    n = (x - t).abs()
    return torch.where(n < beta, 0.5 * n * n / beta, n - 0.5 * beta)


def rpn_loss(obj, deltas, anchors, size, gt, gen, c):
    h, w = size
    labels_idx = match(vid.iou(gt["boxes"], anchors), gt["valid"], 0.7, 0.3, True)
    labels = torch.where(labels_idx >= 0, 1.0, torch.where(labels_idx == BELOW, 0.0, -1.0))
    visible = (anchors[:, 0] >= 0) & (anchors[:, 1] >= 0) & (anchors[:, 2] < w) & \
        (anchors[:, 3] < h)
    labels = torch.where(visible, labels, torch.full_like(labels, -1.0))
    targets = encode(gt["boxes"][labels_idx.clamp_min(0)], anchors, (1.0, 1.0, 1.0, 1.0))
    pos, neg = balanced(labels, c["rpn_batch_size"], c["rpn_positive_fraction"], gen)
    sampled = pos | neg
    n = sampled.sum().clamp_min(1)
    box = (smooth_l1(deltas, targets, 1.0 / 9).sum(-1) * pos).sum() / n
    bce = -(labels * F.logsigmoid(obj) + (1.0 - labels) * F.logsigmoid(-obj))
    return (bce * sampled).sum() / n, box


def subsample(props, gt, gen, c):
    """The training ROIs: proposals with the padded ground truth appended,
    matched at 0.5, ``roi_batch_size`` sampled at ``roi_positive_fraction``
    positives, sampled slots first."""
    boxes = torch.cat([props.boxes, gt["boxes"]])
    valid = torch.cat([props.valid, gt["valid"]])
    iou = torch.where(valid[None], vid.iou(gt["boxes"], boxes), torch.full((1,), -1.0,
                                                                           device=boxes.device))
    m = match(iou, gt["valid"], 0.5, 0.5, False)
    labels = torch.where(m >= 0, gt["labels"][m.clamp_min(0)],
                         torch.where(m == BELOW, 0, -1))
    labels = torch.where(valid, labels, torch.full_like(labels, -1))
    targets = encode(gt["boxes"][m.clamp_min(0)], boxes, c["bbox_reg_weights"])
    n = c["roi_batch_size"]
    pos, neg = balanced(labels, n, c["roi_positive_fraction"], gen)
    sampled = pos | neg
    tiebreak = torch.rand((1, len(labels)), generator=gen, device=boxes.device)[0]
    slot = torch.sort(sampled.float() * 2.0 + tiebreak, descending=True, stable=True).indices[:n]
    ok = sampled[slot]
    return boxes[slot], ok, torch.where(ok, labels[slot], 0), targets[slot]


def fastrcnn_loss(logits, deltas, ok, labels, targets):
    n = ok.sum().clamp_min(1)
    ce = -F.log_softmax(logits, -1).gather(1, labels[:, None])[:, 0]
    reg = deltas.gather(1, labels[:, None] * 4 + torch.arange(4, device=labels.device))
    pos = ok & (labels > 0)
    return (ce * ok).sum() / n, (smooth_l1(reg, targets, 1.0).sum(-1) * pos).sum() / n


def _ref_props(c4, size, P, c, prec):
    obj, dl = vid.rpn(c4, P, prec)
    anchors = vid.anchors_for(c, c4.shape[2], c4.shape[3], c4.device)
    return vid.proposals(obj.detach(), dl.detach(), anchors, size, c["ref_pre_nms_top_n"],
                         c["ref_post_nms_top_n"], c["rpn_nms_thresh"])


def losses(sample: dict, gen, P: dict, c: dict, prec) -> dict:
    """One sample's four losses. sample: "local" / "memory" / "global" each
    (NCHW normalized frames, [(h, w)] sizes), cur first in "local"; "gt":
    boxes (G, 4), labels (G,), valid (G,)."""
    a = c["attention"]
    bn = c["ref_post_nms_top_n"]
    an = int(bn * c["ratio"])
    gt = sample["gt"]
    imgs_l, sizes_l = sample["local"]
    imgs_m, sizes_m = sample["memory"]
    imgs_g, sizes_g = sample["global"]
    feats_l = vid.backbone(imgs_l, P, c, prec)
    feats_g = vid.backbone(imgs_g, P, c, prec)
    with torch.no_grad():
        feats_m = vid.backbone(imgs_m, P, c, prec)
        m_props = [_ref_props(feats_m[i:i + 1], sizes_m[i], P, c, prec)
                   for i in range(len(sizes_m))]
        g_props = [_ref_props(feats_g[i:i + 1].detach(), sizes_g[i], P, c, prec)
                   for i in range(len(sizes_g))]
    obj, dl = vid.rpn(feats_l[:1], P, prec)
    anchors = vid.anchors_for(c, feats_l.shape[2], feats_l.shape[3], feats_l.device)
    loss_obj, loss_rpn_box = rpn_loss(obj, dl, anchors, sizes_l[0], gt, gen, c)
    train_props = vid.proposals(obj.detach(), dl.detach(), anchors, sizes_l[0],
                                c["pre_nms_top_n_train"], c["post_nms_top_n_train"],
                                c["rpn_nms_thresh"])
    rois, ok, labels, targets = subsample(train_props, gt, gen, c)
    l_props = [_ref_props(feats_l[i:i + 1].detach(), sizes_l[i], P, c, prec)
               for i in range(len(sizes_l))]

    def fc0_of(maps, props):
        return torch.cat([vid.fc0(maps[i:i + 1], p.boxes, P, c, prec) for i, p in enumerate(props)])

    def cat(props, field):
        return torch.cat([getattr(p, field) for p in props])

    def distill(x, frames):
        return x.reshape(frames, bn, *x.shape[1:])[:, :an].reshape(-1, *x.shape[1:])

    def g_attn(x, i):
        return x + vid.attention(x, g_feats, g_valid, P, f"extractor.g_attn_{i}", prec,
                                 groups=a["groups"])

    def local(i, cur_rois, feats, rois_, feats_, valid_, last):
        out = feats + vid.attention(feats, feats_, valid_, P, f"extractor.l_attn_{i}", prec,
                                    pos=(cur_rois, rois_), groups=a["groups"])
        return out if last else torch.relu(vid.dense(out, P, f"extractor.l_fcs_{i + 1}", prec))

    g_feats = fc0_of(vid.res5(feats_g, P, "extractor", c, prec), g_props)
    g_valid = cat(g_props, "valid")
    with torch.no_grad():
        fm = len(m_props)
        x_m = g_attn(fc0_of(vid.res5(feats_m, P, "extractor", c, prec), m_props), 0)
        m_rois, m_valid = cat(m_props, "boxes"), cat(m_props, "valid")
        m_rois_d, m_valid_d = distill(m_rois, fm), distill(m_valid, fm)
        mem = [(m_rois, x_m, m_valid)]
        feats = distill(x_m, fm)
        for i in range(a["stages"] - 1):
            feats = local(i, m_rois_d, feats, *mem[i], last=False)
            mem.append((m_rois_d, feats, m_valid_d))
    fl = len(l_props)
    enh_l = vid.res5(feats_l, P, "extractor", c, prec)
    x_key = vid.fc0(enh_l[:1], rois, P, c, prec)
    x_l = fc0_of(enh_l, l_props)
    n_key = len(rois)
    both = g_attn(torch.cat([x_key, x_l]), 0)
    x_key, x_l = both[:n_key], both[n_key:]
    l_rois, l_valid = cat(l_props, "boxes"), cat(l_props, "valid")
    rois_d, valid_d = distill(l_rois, fl), distill(l_valid, fl)
    cur_full = torch.cat([rois, rois_d])
    feats = torch.cat([x_key, distill(x_l, fl)])
    for i in range(a["stages"]):
        last = i == a["stages"] - 1
        cur = cur_full
        if i == 0:
            refs = (l_rois, x_l, l_valid)
        else:
            refs = (rois_d, feats[n_key:], valid_d)
            if last:
                cur, feats = rois, feats[:n_key]
        refs = tuple(torch.cat([r, m]) for r, m in zip(refs, mem[i]))
        feats = local(i, cur, feats, *refs, last=last)
    for i in range(c["global_res_stage"]):
        feats = g_attn(feats, i + 1)
    logits = vid.dense(feats, P, "predictor.cls_score", prec)
    deltas = vid.dense(feats, P, "predictor.bbox_pred", prec)
    loss_cls, loss_box = fastrcnn_loss(logits, deltas, ok, labels, targets)
    return {"loss_objectness": loss_obj, "loss_rpn_box_reg": loss_rpn_box,
            "loss_classifier": loss_cls, "loss_box_reg": loss_box}


def lr_factor(it: int, c: dict) -> float:
    s = c["solver"]
    if it < s["warmup_iters"]:
        alpha = it / s["warmup_iters"]
        return s["warmup_factor"] * (1 - alpha) + alpha
    return 1.0


def train(samples_by_step: list, gens: list, P: dict, trainable: list, c: dict,
          prec_mode: str = "float32", drop=None) -> dict:
    """Steps of plain SGD over all the samples of each step (their mean),
    from ``P``. Returns per step the mean losses, the first step's
    gradients and the parameters after the last step (trainable leaves).
    ``drop``: indices of samples left out of every step (the mean taken
    over the rest), for a planted fault."""
    s = c["solver"]
    prec = STPrecision(prec_mode)
    W = {k: (v.detach().clone().requires_grad_(True) if k in trainable else v)
         for k, v in P.items()}
    momentum = {}
    out = {"losses": [], "grad0": None}
    for it, samples in enumerate(samples_by_step):
        keep = [i for i in range(len(samples)) if not drop or i not in drop]
        totals = {}
        for i in keep:
            parts = losses(samples[i], gens[i], W, c, prec)
            (sum(parts.values()) / len(keep)).backward()
            for k, v in parts.items():
                totals[k] = totals.get(k, 0.0) + float(v.detach()) / len(keep)
        out["losses"].append(totals)
        with torch.no_grad():
            if it == 0:
                out["grad0"] = {k: W[k].grad.clone() for k in trainable}
            lr = s["base_lr"] * lr_factor(it, c)
            for k in trainable:
                bias = k.rsplit(".", 1)[-1] == "bias"
                wd = s["weight_decay_bias"] if bias else s["weight_decay"]
                step_lr = lr * (s["bias_lr_factor"] if bias else 1.0)
                d = W[k].grad + wd * W[k]
                momentum[k] = d if it == 0 else s["momentum"] * momentum[k] + d
                W[k] -= step_lr * momentum[k]
                W[k].grad = None
    out["params"] = {k: W[k].detach() for k in trainable}
    return out
