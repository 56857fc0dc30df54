"""Fixed-shape exact greedy NMS (counterpart of ``mega_pytorch_tpu/ops/nms.py``).

Same greedy semantics as the reference CUDA NMS: boxes in score order; a box
is suppressed when its IoU (+1 areas, 1e-12 floor) with a kept box exceeds
the threshold. Two layers, as in the JAX package:

1. ``_peel``: independent-set rounds over the rank-ordered overlap mask.
   Every undecided box with no undecided higher-ranked overlapper is kept,
   and what it overlaps is removed.
2. ``_chunked_keep_mask`` (N > max(chunk, 2*max_outputs)): rank-ordered
   chunks, each suppressed against the boxes kept so far, peeled, and
   appended, until max_outputs boxes are kept.

Every function takes a leading batch dimension (images or classes). Each
peel round and each chunk step asks the host whether work remains, which
costs one device synchronisation per round.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _pair_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, C, 4) x (B, K, 4) → (B, C, K) IoU, +1 convention."""
    area_a = (a[..., 2] - a[..., 0] + 1.0) * (a[..., 3] - a[..., 1] + 1.0)
    area_b = (b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt + 1.0).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp_min(1e-12)


def _peel(bb: torch.Tensor, vv: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Exact greedy keep mask over score-sorted (B, m, 4) boxes; vv (B, m)
    marks the still-eligible ones."""
    m = bb.shape[1]
    rank = torch.arange(m, device=bb.device)
    # overlap[b, j, i]: higher-ranked j suppresses i when kept
    overlap = (_pair_iou(bb, bb) > iou_threshold) & (rank[:, None] < rank[None, :])
    kept = torch.zeros_like(vv)
    undecided = vv.clone()
    while bool(undecided.any()):
        blocked = (undecided[:, :, None] & overlap).any(dim=1)
        safe = undecided & ~blocked
        removed = (safe[:, :, None] & overlap).any(dim=1)
        kept |= safe
        undecided &= ~safe & ~removed
    return kept


def _chunked_keep_mask(b, v, iou_threshold, max_outputs, chunk):
    """Keep mask over score-sorted (B, N, 4) boxes via rank-ordered chunks;
    stops once max_outputs boxes are kept."""
    bsz, n = v.shape
    k = max_outputs
    pad = (-n) % chunk
    if pad:
        b = torch.cat([b, b.new_ones((bsz, pad, 4))], 1)
        v = torch.cat([v, v.new_zeros((bsz, pad))], 1)
    n_chunks = b.shape[1] // chunk
    chv = v.reshape(bsz, n_chunks, chunk).any(-1)
    has_valid_from = chv.flip(-1).cumsum(-1).flip(-1) > 0  # (B, n_chunks)
    kept_n = torch.zeros(bsz, dtype=torch.long, device=b.device)
    kept_boxes = b.new_ones((bsz, k, 4))
    kept_mask = torch.zeros_like(v)
    slot = torch.arange(k, device=b.device)
    rows = torch.arange(bsz, device=b.device)[:, None]
    for t in range(n_chunks):
        active = (kept_n < k) & has_valid_from[:, t]
        if not bool(active.any()):
            break
        cb = b[:, t * chunk:(t + 1) * chunk]
        cv = v[:, t * chunk:(t + 1) * chunk] & active[:, None]
        hit = (_pair_iou(cb, kept_boxes) > iou_threshold) & (slot < kept_n[:, None])[:, None, :]
        cv = cv & ~hit.any(-1)
        ck = _peel(cb, cv, iou_threshold)
        pos = ck.long().cumsum(-1) - 1 + kept_n[:, None]
        take = ck & (pos < k)
        # scatter the new keeps into their slots; the rest go to a spill slot
        spill = torch.cat([kept_boxes, kept_boxes.new_ones((bsz, 1, 4))], 1)
        spill[rows, torch.where(take, pos, torch.full_like(pos, k))] = cb
        kept_boxes = spill[:, :k]
        kept_mask[:, t * chunk:(t + 1) * chunk] = take
        kept_n = kept_n + take.sum(-1)
    return kept_mask[:, :n]


def nms(boxes, scores, valid, iou_threshold: float, max_outputs: int,
        chunk: int = 1024, extras: tuple = (), return_boxes: bool = False,
        presorted: bool = False):
    """Batched greedy NMS with a static output size.

    boxes (B, N, 4), scores (B, N), valid (B, N) bool. ``presorted`` means the
    scores are already descending (a stable descending sort's output);
    otherwise they are sorted ascending and stable, then reversed, so equal
    scores end up high-index first. ``extras`` are (B, N) or (B, N, D)
    tensors returned at the keep slots; ``return_boxes`` adds the kept boxes.

    Returns ``(keep_idx, keep_valid)`` or, with payload requested,
    ``(keep_idx, keep_valid, kept)`` where ``kept`` is
    ``(boxes_if_requested, *extras)`` gathered at the keep slots. Slots past
    the kept boxes hold the next non-kept candidates in rank order; slots past
    N (when N < max_outputs) hold zeros and index 0.
    """
    bsz, n = scores.shape
    dev = boxes.device
    if presorted:
        order = torch.arange(n, device=dev).expand(bsz, n)
    else:
        masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
        order = torch.sort(masked, dim=-1, stable=True).indices.flip(-1)

    def take(x, idx):
        return torch.gather(x, 1, idx if x.dim() == 2 else
                            idx[..., None].expand(*idx.shape, x.shape[-1]))

    v = take(valid, order)
    b = take(boxes, order)
    if n <= max(chunk, 2 * max_outputs):
        kept = _peel(b, v, iou_threshold)
    else:
        kept = _chunked_keep_mask(b, v, iou_threshold, max_outputs, chunk)

    # first max_outputs kept boxes in rank order, then the others in rank order
    rank = torch.arange(n, device=dev)
    pick = torch.where(kept, n - rank, torch.zeros_like(rank))
    slots = torch.sort(-pick, dim=-1, stable=True).indices
    k = min(max_outputs, n)
    slots = slots[:, :k]
    keep_valid = torch.gather(kept, 1, slots)
    keep_idx = torch.gather(order, 1, slots)
    kept_out = []
    if return_boxes:
        kept_out.append(take(boxes, keep_idx))
    kept_out.extend(take(e, keep_idx) for e in extras)
    if k < max_outputs:
        pad = max_outputs - k

        def padded(x):
            return torch.cat([x, x.new_zeros((bsz, pad, *x.shape[2:]))], 1)

        keep_idx, keep_valid = padded(keep_idx), padded(keep_valid)
        kept_out = [padded(x) for x in kept_out]
    if not extras and not return_boxes:
        return keep_idx, keep_valid
    return keep_idx, keep_valid, tuple(kept_out)


def batched_nms(boxes, scores, valid, iou_threshold: float, max_outputs: int):
    """The JAX package's ``batched_nms`` (its ``nms`` vmapped over a leading
    class or image axis): (B, N, 4) boxes, (B, N) scores and valid →
    (B, K) keep_idx, keep_valid. ``nms`` here takes that axis already."""
    return nms(boxes, scores, valid, iou_threshold, max_outputs)
