"""Faster R-CNN (ResNet-50 FPN v2), the reference's other detection critic and
probe (the port of ``unirestore_tpu/tasks/fasterrcnn.py``; torchvision's
``fasterrcnn_resnet50_fpn_v2``, chosen by ``downstream: fastrcnn``,
engine_unifie.py:319-336).

As in the JAX file, with fixed shapes throughout:

- ResNet-50 + FPN over c2..c5 (P2..P5) and a stride-2 P6 for the RPN; RPN
  head v2 (two 3x3 convs), 3 anchors per cell (one size per level x 3 ratios).
- Proposals: the global top ``PRE_NMS`` by objectness, then greedy NMS at
  IoU 0.7 over that fixed set on the device (``_greedy_nms_mask``: a loop of
  ``POST_NMS`` steps on device tensors, no host read).
- Multi-scale ROIAlign (7 x 7, sampling 2, level clamp(floor(4 +
  log2(sqrt(area) / 224)), 2, 5)). The JAX function samples every level and
  then selects one per box; here each box samples only its own level, from
  one table of all levels' features, with the same arithmetic.
- Box head v2 (4 x conv3x3 + BN, fc 1024) and a 91-way predictor with boxes
  per class; class-wise NMS on the host at inference.
- Training loss: sampled RPN BCE + smooth L1 and sampled ROI CE + smooth L1,
  torchvision's matching thresholds and sampling fractions.

Randomness: the JAX loss draws its sampling scores with ``jax.random.uniform``
from ``PRNGKey(0)`` when it is given no key, which the JAX engine never gives,
so every call draws the same sample. Those draws cannot be made in torch, so
``fasterrcnn_loss`` takes them as tensors (``uniforms``); without them it
draws them from a ``torch.Generator`` seeded 0 on each call, the same "one
fixed sample every step".
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..nn import layers as L
from . import resnet as RN
from .retinanet import (_pairwise_iou, decode_boxes, detector_input, encode_boxes, match,
                        nms, on_device, take)

LEVELS = (2, 3, 4, 5)        # P2..P5 (+ P6 for the RPN only)
ANCHOR_SIZES = (32, 64, 128, 256, 512)   # one per level P2..P6
RATIOS = (0.5, 1.0, 2.0)
A = len(RATIOS)
PRE_NMS = 1024               # global top-K proposals before NMS
POST_NMS = 256               # proposals kept after NMS
ROI_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


def fasterrcnn_init(ini, num_classes: int = 91, channels: int = 256):
    """The parameter tree (``ini``: an ``nn.init.Init``); the backbone has no ``fc``."""
    p = {"backbone": RN.resnet_init(ini, "resnet50")}
    del p["backbone"]["fc"]
    p["lateral"] = {f"c{i}": L.conv2d_init(ini, c, channels, 1)
                    for i, c in ((2, 256), (3, 512), (4, 1024), (5, 2048))}
    p["smooth"] = {f"p{i}": L.conv2d_init(ini, channels, channels, 3) for i in LEVELS}
    p["rpn"] = {"convs": [L.conv2d_init(ini, channels, channels, 3) for _ in range(2)],
                "cls": L.conv2d_init(ini, channels, A, 1),
                "box": L.conv2d_init(ini, channels, A * 4, 1)}
    p["box_head"] = {
        "convs": [{"conv": L.conv2d_init(ini, channels, channels, 3, bias=False),
                   "bn": RN.bn_init(ini, channels)} for _ in range(4)],
        "fc": L.linear_init(ini, channels * 7 * 7, 1024)}
    p["cls_score"] = L.linear_init(ini, 1024, num_classes)
    p["bbox_pred"] = L.linear_init(ini, 1024, num_classes * 4)
    return p


def fpn_features(p, images, preprocess_input: bool = True) -> dict:
    """{2..5: P2..P5, 6: P6 (P5 at stride 2)}, NHWC."""
    x = RN.normalize(images) if preprocess_input else images
    f = RN.resnet_features(p["backbone"], x)
    laterals = {i: L.conv2d(p["lateral"][f"c{i}"], f[f"c{i}"], padding=0) for i in LEVELS}
    top = laterals[5]
    feats = {5: top}
    for i in (4, 3, 2):
        # nearest-resize to the lateral's exact size (odd sizes break a plain 2x)
        top = laterals[i] + L.resize_nearest(top, laterals[i].shape[1:3])
        feats[i] = top
    for i in LEVELS:
        feats[i] = L.conv2d(p["smooth"][f"p{i}"], feats[i], padding=1)
    # the JAX max pool over a 1 x 1 window at stride 2
    feats[6] = feats[5][:, ::2, ::2]
    return feats


def rpn_anchors_for_shape(h: int, w: int) -> np.ndarray:
    """The RPN's anchors (N, 4) xyxy for an (h, w) input, P2..P6, ratio-major per level."""
    out = []
    for li, lvl in enumerate((2, 3, 4, 5, 6)):
        stride = 2 ** lvl
        size = ANCHOR_SIZES[li]
        fh, fw = math.ceil(h / stride), math.ceil(w / stride)
        cy = (np.arange(fh) + 0.5) * stride
        cx = (np.arange(fw) + 0.5) * stride
        yy, xx = np.meshgrid(cy, cx, indexing="ij")
        for r in RATIOS:
            aw = size * math.sqrt(1.0 / r)
            ah = size * math.sqrt(r)
            out.append(np.stack([xx - aw / 2, yy - ah / 2, xx + aw / 2, yy + ah / 2],
                                -1).reshape(-1, 4))
    return np.concatenate(out).astype(np.float32)


def _rpn_outputs(p, feats):
    """Flat (B, N) objectness and (B, N, 4) deltas in ``rpn_anchors_for_shape``'s order."""
    obj, box = [], []
    for lvl in (2, 3, 4, 5, 6):
        x = feats[lvl]
        for conv in p["rpn"]["convs"]:
            x = F.relu(L.conv2d(conv, x, padding=1))
        o = L.conv2d(p["rpn"]["cls"], x, padding=0)
        b = L.conv2d(p["rpn"]["box"], x, padding=0)
        n, fh, fw, _ = o.shape
        obj.append(o.reshape(n, fh * fw, A).transpose(1, 2).reshape(n, -1))
        box.append(b.reshape(n, fh * fw, A, 4).transpose(1, 2).reshape(n, -1, 4))
    return torch.cat(obj, 1), torch.cat(box, 1)


def _greedy_nms_mask(boxes, scores, iou_thr: float, keep: int):
    """Greedy NMS over a fixed candidate set, on the device.

    boxes: (..., K, 4) sorted by score, descending; scores: (..., K). Returns
    (..., keep) indices into K: at each of ``keep`` steps the highest-scoring
    candidate still alive, which then suppresses every candidate above
    ``iou_thr`` and itself. Once none is alive the step picks index 0, as the
    JAX function's argmax over zeros does.
    """
    k = boxes.shape[-2]
    iou = _pairwise_iou(boxes, boxes)
    alive = torch.ones(scores.shape, dtype=torch.bool, device=boxes.device)
    lifted = scores + 1e3
    ks = torch.arange(k, device=boxes.device)
    out = []
    for _ in range(keep):
        idx = torch.argmax(alive * lifted, dim=-1)
        out.append(idx)
        row = torch.gather(iou, -2, idx[..., None, None].expand(*idx.shape, 1, k))[..., 0, :]
        alive = alive & ~(row > iou_thr) & (ks != idx[..., None])
    return torch.stack(out, dim=-1)


def _proposals(p, feats, h, w):
    """(B, post, 4) proposal boxes (post = POST_NMS clamped to the anchors),
    and (objectness, deltas, anchors) for the RPN loss."""
    obj, deltas = _rpn_outputs(p, feats)
    anchors = on_device(rpn_anchors_for_shape, h, w, device=obj.device)
    pre = min(PRE_NMS, anchors.shape[0])
    post = min(POST_NMS, pre)
    scores, idx = torch.topk(obj, pre, dim=1)
    boxes = decode_boxes(anchors[idx], take(deltas, idx).float())
    boxes = torch.stack([torch.clamp(boxes[..., 0], 0, w), torch.clamp(boxes[..., 1], 0, h),
                         torch.clamp(boxes[..., 2], 0, w), torch.clamp(boxes[..., 3], 0, h)],
                        dim=-1)
    keep = _greedy_nms_mask(boxes, torch.sigmoid(scores.float()), 0.7, post)
    return take(boxes, keep), (obj, deltas, anchors)


def _level_table(sizes) -> np.ndarray:
    """Per level P2..P5: (scale, height, width, first row in the table of all levels)."""
    offsets = np.cumsum([0] + [fh * fw for fh, fw in sizes])[:-1]
    return np.asarray([[1.0 / 2 ** lvl, fh, fw, off]
                       for lvl, (fh, fw), off in zip(LEVELS, sizes, offsets)], np.float32)


def _roi_align(feats, boxes, out_size: int = 7, sampling: int = 2):
    """Multi-scale ROIAlign over P2..P5.

    feats: {lvl: (B, H_l, W_l, C)}; boxes: (B, R, 4) xyxy. Returns (B, R, 7, 7, C).
    Each box samples its own level (the JAX function's selection) from one
    table of every level's rows.
    """
    bsz, r = boxes.shape[:2]
    c = feats[2].shape[-1]
    dev = boxes.device
    areas = torch.clamp(boxes[..., 2] - boxes[..., 0], min=1e-6) * \
        torch.clamp(boxes[..., 3] - boxes[..., 1], min=1e-6)
    k = torch.floor(4 + torch.log2(torch.sqrt(areas) / 224.0 + 1e-9))
    li = torch.clamp(k, 2, 5).long() - 2  # (B, R) level index
    sizes = [tuple(feats[lvl].shape[1:3]) for lvl in LEVELS]
    per_image = sum(fh * fw for fh, fw in sizes)
    table = torch.cat([feats[lvl].reshape(bsz, -1, c) for lvl in LEVELS], 1).reshape(-1, c)
    lv = on_device(_level_table, tuple(sizes), device=dev)
    scale, fh, fw, off = lv[li].unbind(-1)  # each (B, R)

    x0, y0, x1, y1 = (boxes * scale[..., None]).unbind(-1)
    bw = torch.clamp(x1 - x0, min=1e-6)
    bh = torch.clamp(y1 - y0, min=1e-6)
    n = out_size * sampling
    steps = torch.arange(n, device=dev, dtype=torch.float32) + 0.5
    ys = y0[..., None] + steps * bh[..., None] / n  # (B, R, n)
    xs = x0[..., None] + steps * bw[..., None] / n

    def axis(v, size):
        v = torch.minimum(torch.clamp(v - 0.5, min=0), (size - 1)[..., None])
        lo = torch.floor(v)
        hi = torch.minimum(lo + 1, (size - 1)[..., None])
        return lo, hi, v - lo

    y0i, y1i, wy = axis(ys, fh)
    x0i, x1i, wx = axis(xs, fw)
    base = (off + torch.arange(bsz, device=dev)[:, None] * per_image)[..., None, None]
    width = fw[..., None, None]

    def at(yi, xi):  # (B, R, n, n, C)
        idx = (base + yi[..., :, None] * width + xi[..., None, :]).long()
        return table.index_select(0, idx.reshape(-1)).reshape(*idx.shape, c)

    wy, wx = wy[..., :, None, None], wx[..., None, :, None]
    v = (at(y0i, x0i) * (1 - wy) * (1 - wx) + at(y1i, x0i) * wy * (1 - wx)
         + at(y0i, x1i) * (1 - wy) * wx + at(y1i, x1i) * wy * wx)
    v = v.reshape(bsz, r, out_size, sampling, out_size, sampling, c)
    return v.mean(dim=(3, 5))


def _box_head(p, rois):
    """(R, 7, 7, C) -> (R, 1024)."""
    x = rois
    for cb in p["box_head"]["convs"]:
        x = F.relu(RN.batch_norm(cb["bn"], L.conv2d(cb["conv"], x, padding=1)))
    flat = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)  # torch's flatten order
    return F.relu(L.linear(p["box_head"]["fc"], flat))


def _roi_outputs(p, feats, proposals):
    """Class logits (B, R, num_classes) and box deltas (B, R, 4 * num_classes), fp32."""
    bsz, r = proposals.shape[:2]
    rois = _roi_align(feats, proposals)
    emb = _box_head(p, rois.reshape(bsz * r, *rois.shape[2:]))
    logits = L.linear(p["cls_score"], emb).float().reshape(bsz, r, -1)
    deltas = L.linear(p["bbox_pred"], emb).float().reshape(bsz, r, -1)
    return logits, deltas


def fasterrcnn_detect(p, images, num_classes: int = 91, score_threshold: float = 0.05,
                      nms_thr: float = 0.5, max_det: int = 100):
    """Inference on [0, 1] NHWC ``images`` (numpy or tensor): a list of
    {boxes, scores, labels} numpy dicts per image. The network runs on the
    critic's device; per-class selection, decode and NMS on the host."""
    with torch.inference_mode():
        x = detector_input(p, images)
        h, w = x.shape[1:3]
        feats = fpn_features(p, x)
        proposals, _ = _proposals(p, feats, h, w)
        logits, deltas = _roi_outputs(p, feats, proposals)
        scores = torch.softmax(logits, -1).cpu().numpy()
        deltas = deltas.cpu().numpy()
        props = proposals.float().cpu().numpy()
    results = []
    wts = np.asarray(ROI_WEIGHTS, np.float32)
    for b in range(x.shape[0]):
        keep_boxes, keep_scores, keep_labels = [], [], []
        for c in range(1, num_classes):  # class 0 is the background
            sc = scores[b, :, c]
            sel = sc > score_threshold
            if not sel.any():
                continue
            d = deltas[b, sel, c * 4:(c + 1) * 4] / wts
            bx = decode_boxes(torch.from_numpy(props[b][sel]), torch.from_numpy(d)).numpy()
            bx[:, 0::2] = np.clip(bx[:, 0::2], 0, w)
            bx[:, 1::2] = np.clip(bx[:, 1::2], 0, h)
            keep = nms(bx, sc[sel], nms_thr, max_det)
            keep_boxes.append(bx[keep])
            keep_scores.append(sc[sel][keep])
            keep_labels.append(np.full(len(keep), c, np.int64))
        if keep_boxes:
            bx = np.concatenate(keep_boxes)
            sc = np.concatenate(keep_scores)
            lb = np.concatenate(keep_labels)
            order = np.argsort(-sc)[:max_det]
            results.append({"boxes": bx[order], "scores": sc[order], "labels": lb[order]})
        else:
            results.append({"boxes": np.zeros((0, 4), np.float32),
                            "scores": np.zeros((0,), np.float32),
                            "labels": np.zeros((0,), np.int64)})
    return results


def _smooth_l1(x, beta):
    ax = torch.abs(x)
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def _kth_largest(x, k: int):
    """The k-th largest value along the last axis, kept as an axis of 1."""
    return torch.topk(x, k, dim=-1).values[..., -1:]


def loss_uniforms(batch: int, h: int, w: int, device):
    """The sampling scores ``fasterrcnn_loss`` draws when it is given none:
    (B, RPN anchors) and (B, post-NMS proposals) uniforms in [0, 1) from a
    generator on ``device`` seeded 0 on every call."""
    n = on_device(rpn_anchors_for_shape, h, w, device=device).shape[0]
    post = min(POST_NMS, PRE_NMS, n)
    gen = torch.Generator(device=device).manual_seed(0)
    return (torch.rand((batch, n), generator=gen, device=device),
            torch.rand((batch, post), generator=gen, device=device))


def fasterrcnn_loss(p, images, gt_boxes, gt_labels, gt_mask, num_classes: int = 91,
                    uniforms=None):
    """RPN + ROI-head training loss on padded targets (torchvision matching
    and sampling: RPN 0.7 / 0.3 match, 256 samples at 0.5 positive; ROI 0.5
    match, 256 samples at 0.25 positive), the mean over the batch of each.

    ``uniforms`` = (rpn (B, N anchors), roi (B, post)) are the sampling scores
    in [0, 1) (``loss_uniforms`` by default). Reads nothing back to the host.
    """
    h, w = images.shape[1:3]
    feats = fpn_features(p, images)
    proposals, (obj, rpn_deltas, anchors) = _proposals(p, feats, h, w)
    rpn_u, roi_u = uniforms if uniforms is not None else loss_uniforms(
        images.shape[0], h, w, images.device)

    # RPN: 128 positives at most, the rest of 256 negatives
    best, best_idx = match(anchors, gt_boxes, gt_mask)
    pos, neg = best >= 0.7, best < 0.3
    pos_rank = torch.where(pos, rpn_u, -1.0)
    neg_rank = torch.where(neg, rpn_u, -1.0)
    pos_sel = (pos_rank >= _kth_largest(pos_rank, 128)) & pos
    neg_sel = (neg_rank >= _kth_largest(neg_rank, 256 - 128)) & neg
    sel = pos_sel | neg_sel
    n_sel = torch.clamp(sel.sum(-1), min=1)
    logits = obj.float()
    bce = torch.where(pos_sel, -F.logsigmoid(logits), -F.logsigmoid(-logits))
    rpn_cls = torch.where(sel, bce, 0.0).sum(-1) / n_sel
    tgt = encode_boxes(anchors, take(gt_boxes, best_idx))
    l1 = _smooth_l1(rpn_deltas.float() - tgt, 1.0 / 9).sum(-1)
    rpn_box = torch.where(pos_sel, l1, 0.0).sum(-1) / n_sel

    # ROI head: 64 foreground at most, the rest of 256 background
    best, best_idx = match(proposals, gt_boxes, gt_mask)
    fg = best >= 0.5
    tgt_label = torch.where(fg, take(gt_labels, best_idx), 0)
    n_keep = min(POST_NMS, 512)
    pos_quota = n_keep // 4
    pos_rank = torch.where(fg, roi_u, -1.0)
    pos_sel = (pos_rank >= _kth_largest(pos_rank, pos_quota)) & fg
    neg_rank = torch.where(~fg, roi_u, -1.0)
    neg_sel = (neg_rank >= _kth_largest(neg_rank, n_keep - pos_quota)) & ~fg
    sel = pos_sel | neg_sel
    n_sel = torch.clamp(sel.sum(-1), min=1)
    logits, deltas = _roi_outputs(p, feats, proposals)
    ce = -torch.gather(torch.log_softmax(logits, -1), -1, tgt_label[..., None])[..., 0]
    roi_cls = torch.where(sel, ce, 0.0).sum(-1) / n_sel
    tgt_d = encode_boxes(proposals, take(gt_boxes, best_idx)) * on_device(
        np.asarray, ROI_WEIGHTS, np.float32, device=images.device)
    cols = tgt_label[..., None] * 4 + torch.arange(4, device=images.device)
    l1 = _smooth_l1(torch.gather(deltas, -1, cols) - tgt_d, 1.0).sum(-1)
    roi_box = torch.where(pos_sel, l1, 0.0).sum(-1) / n_sel
    return (rpn_cls + rpn_box).mean() + (roi_cls + roi_box).mean()
