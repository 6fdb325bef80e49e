"""RetinaNet (ResNet-50 FPN), the frozen detection critic of stage 3 and its
validation detector (the port of ``unirestore_tpu/tasks/retinanet.py``).

The reference trains against torchvision's ``retinanet_resnet50_fpn_v2``
(the loss is the sum of the detector's loss dict, eval_detection.py:164-192)
and probes mAP with it (:242-253). As in the JAX file: FPN P3-P7 over the
ResNet's c3-c5, shared 4-conv heads with GroupNorm 32, 9 anchors per cell (3
scales x 3 ratios), focal classification loss plus L1 box regression on
padded, masked targets, and decode with class-wise NMS on the host at
inference. The tree has the JAX tree's keys and shapes (conv kernels OIHW),
so ``bridge.critics_from_jax`` and the converted
``weights/retinanet_resnet50.npz`` read the same files.

The box helpers (``encode_boxes``, ``decode_boxes``, ``_pairwise_iou``,
``nms``, ``pad_targets``) are shared with ``fasterrcnn.py``; the three on
tensors take any leading batch dimensions, so ``retinanet_loss`` matches
every image of a batch at once where the JAX function maps over images.
Anchors are made on the host once per (image size, device) and kept there,
so that a loss copies nothing from the host after its first call.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..evalx.metrics import box_iou
from ..nn import layers as L
from . import resnet as RN

NUM_ANCHORS = 9
LEVELS = (3, 4, 5, 6, 7)  # P3..P7, strides 8..128
FOCAL_ALPHA = 0.25
FOCAL_GAMMA = 2.0


def retinanet_init(ini, num_classes: int = 91, channels: int = 256):
    """The parameter tree (``ini``: an ``nn.init.Init``); the classification
    bias starts at the focal-loss prior 0.01."""
    p = {"backbone": RN.resnet_init(ini, "resnet50")}
    p["lateral"] = {f"c{i}": L.conv2d_init(ini, c, channels, 1)
                    for i, c in ((3, 512), (4, 1024), (5, 2048))}
    p["smooth"] = {f"p{i}": L.conv2d_init(ini, channels, channels, 3) for i in (3, 4, 5)}
    p["p6"] = L.conv2d_init(ini, 2048, channels, 3)
    p["p7"] = L.conv2d_init(ini, channels, channels, 3)

    def head(ncout):
        return {"convs": [L.conv2d_init(ini, channels, channels, 3) for _ in range(4)],
                "norms": [L.norm_init(ini, channels) for _ in range(4)],
                "out": L.conv2d_init(ini, channels, ncout, 3)}

    p["cls_head"] = head(NUM_ANCHORS * num_classes)
    prior = 0.01
    p["cls_head"]["out"]["b"] = torch.full_like(p["cls_head"]["out"]["b"],
                                                -math.log((1 - prior) / prior))
    p["box_head"] = head(NUM_ANCHORS * 4)
    return p


def _head_apply(h, x):
    for conv, norm in zip(h["convs"], h["norms"]):
        x = F.relu(L.group_norm(norm, L.conv2d(conv, x, padding=1), groups=32))
    return L.conv2d(h["out"], x, padding=1)


def retinanet_features(p, images, preprocess_input: bool = True):
    """Per-level (cls_logits, box_deltas) lists, P3..P7, NHWC."""
    x = RN.normalize(images) if preprocess_input else images
    f = RN.resnet_features(p["backbone"], x)
    p5 = L.conv2d(p["lateral"]["c5"], f["c5"], padding=0)
    p4 = L.conv2d(p["lateral"]["c4"], f["c4"], padding=0)
    p4 = p4 + L.resize_nearest(p5, p4.shape[1:3])
    p3 = L.conv2d(p["lateral"]["c3"], f["c3"], padding=0)
    p3 = p3 + L.resize_nearest(p4, p3.shape[1:3])
    p3 = L.conv2d(p["smooth"]["p3"], p3, padding=1)
    p4 = L.conv2d(p["smooth"]["p4"], p4, padding=1)
    p5 = L.conv2d(p["smooth"]["p5"], p5, padding=1)
    p6 = L.conv2d(p["p6"], f["c5"], stride=2, padding=1)
    p7 = L.conv2d(p["p7"], F.relu(p6), stride=2, padding=1)
    feats = [p3, p4, p5, p6, p7]
    return ([_head_apply(p["cls_head"], x) for x in feats],
            [_head_apply(p["box_head"], x) for x in feats])


def anchors_for_shape(h: int, w: int) -> np.ndarray:
    """All anchors (N, 4) xyxy for an (h, w) input, P3..P7, torchvision
    convention: sizes 32..512 * {1, 2^(1/3), 2^(2/3)}, ratios {0.5, 1, 2}."""
    out = []
    for lvl in LEVELS:
        stride = 2 ** lvl
        size = 4 * stride
        fh, fw = math.ceil(h / stride), math.ceil(w / stride)
        scales = [size * 2 ** (k / 3) for k in range(3)]
        cy = (np.arange(fh) + 0.5) * stride
        cx = (np.arange(fw) + 0.5) * stride
        for s in scales:
            for r in (0.5, 1.0, 2.0):
                aw = s * math.sqrt(1.0 / r)
                ah = s * math.sqrt(r)
                yy, xx = np.meshgrid(cy, cx, indexing="ij")
                out.append(np.stack([xx - aw / 2, yy - ah / 2, xx + aw / 2, yy + ah / 2],
                                    axis=-1).reshape(-1, 4))
    return np.concatenate(out).astype(np.float32)


_CONSTANTS: dict = {}


def on_device(make, *args, device) -> torch.Tensor:
    """``make(*args)`` (a numpy array) as a tensor on ``device``, made once per
    (function, arguments, device), so that a loss copies nothing from the host
    after its first call; a normal tensor even under ``inference_mode``."""
    key = (make.__module__, make.__qualname__, args, str(device))
    if key not in _CONSTANTS:
        with torch.inference_mode(False):
            _CONSTANTS[key] = torch.as_tensor(make(*args), device=device)
    return _CONSTANTS[key]


def _flatten_outputs(cls_out, box_out, num_classes):
    """(B, sum_l fh*fw*A, C) and (..., 4) in ``anchors_for_shape``'s order:
    the anchors enumerate (scale, ratio) majors per level while the head lays
    them innermost, so the head outputs are reordered."""
    cls_flat, box_flat = [], []
    for c, b in zip(cls_out, box_out):
        n, fh, fw, _ = c.shape
        cls_flat.append(c.reshape(n, fh * fw, NUM_ANCHORS, num_classes).transpose(1, 2)
                        .reshape(n, -1, num_classes))
        box_flat.append(b.reshape(n, fh * fw, NUM_ANCHORS, 4).transpose(1, 2).reshape(n, -1, 4))
    return torch.cat(cls_flat, 1), torch.cat(box_flat, 1)


def encode_boxes(anchors, boxes):
    """xyxy ``boxes`` -> (dx, dy, dw, dh) deltas relative to ``anchors`` (both (..., 4))."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + aw / 2
    ay = anchors[..., 1] + ah / 2
    gw = torch.clamp(boxes[..., 2] - boxes[..., 0], min=1e-6)
    gh = torch.clamp(boxes[..., 3] - boxes[..., 1], min=1e-6)
    gx = boxes[..., 0] + gw / 2
    gy = boxes[..., 1] + gh / 2
    return torch.stack([(gx - ax) / aw, (gy - ay) / ah, torch.log(gw / aw),
                        torch.log(gh / ah)], dim=-1)


def decode_boxes(anchors, deltas):
    """(dx, dy, dw, dh) ``deltas`` relative to ``anchors`` -> xyxy (both (..., 4))."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + aw / 2
    ay = anchors[..., 1] + ah / 2
    cx = deltas[..., 0] * aw + ax
    cy = deltas[..., 1] * ah + ay
    w = torch.exp(torch.clamp(deltas[..., 2], -10, 4)) * aw
    h = torch.exp(torch.clamp(deltas[..., 3], -10, 4)) * ah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def _pairwise_iou(a, b):
    """IoU of (..., N, 4) and (..., M, 4) xyxy boxes: (..., N, M)."""
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0) * torch.clamp(a[..., 3] - a[..., 1], min=0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0) * torch.clamp(b[..., 3] - b[..., 1], min=0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / torch.clamp(area_a[..., :, None] + area_b[..., None, :] - inter, min=1e-9)


def match(anchors, gt_boxes, gt_mask):
    """Each anchor's best IoU over the valid targets and that target's index:
    (B, N) each for anchors (N, 4) or (B, N, 4) and targets (B, M, 4). Padded
    targets count as IoU -1; ties go to the first target."""
    iou = _pairwise_iou(anchors, gt_boxes)
    iou = torch.where(gt_mask[:, None, :], iou, -1.0)
    return iou.max(dim=-1)


def take(values, index):
    """``values`` (B, M, ...) gathered along M by ``index`` (B, N): (B, N, ...)."""
    flat = index.reshape(index.shape[0], -1)
    picked = torch.gather(values, 1, flat.reshape(*flat.shape, *([1] * (values.ndim - 2)))
                          .expand(*flat.shape, *values.shape[2:]))
    return picked.reshape(*index.shape, *values.shape[2:])


def retinanet_loss(p, images, gt_boxes, gt_labels, gt_mask, num_classes: int = 91):
    """Training loss on padded targets, the mean over the batch of focal
    classification loss plus L1 box loss, each over the image's positives.

    gt_boxes: (B, M, 4) xyxy; gt_labels: (B, M) int; gt_mask: (B, M) bool.
    Matching: IoU >= 0.5 positive, < 0.4 background, else ignored
    (torchvision RetinaNet thresholds). Reads nothing back to the host.
    """
    h, w = images.shape[1:3]
    cls_out, box_out = retinanet_features(p, images)
    cls_logits, box_deltas = _flatten_outputs(cls_out, box_out, num_classes)
    anchors = on_device(anchors_for_shape, h, w, device=images.device)

    best, best_idx = match(anchors, gt_boxes, gt_mask)  # (B, N)
    pos = best >= 0.5
    ignore = (best >= 0.4) & ~pos
    classes = torch.arange(num_classes, device=images.device)
    tgt_cls = ((take(gt_labels, best_idx)[..., None] == classes) & pos[..., None]).float()
    p_sig = torch.sigmoid(cls_logits.float())
    ce = -(tgt_cls * torch.log(p_sig + 1e-8) + (1 - tgt_cls) * torch.log(1 - p_sig + 1e-8))
    p_t = tgt_cls * p_sig + (1 - tgt_cls) * (1 - p_sig)
    alpha_t = tgt_cls * FOCAL_ALPHA + (1 - tgt_cls) * (1 - FOCAL_ALPHA)
    focal = alpha_t * (1 - p_t) ** FOCAL_GAMMA * ce
    focal = torch.where(ignore[..., None], 0.0, focal)
    n_pos = torch.clamp(pos.sum(dim=1), min=1)
    cls_loss = focal.sum(dim=(1, 2)) / n_pos

    tgt_deltas = encode_boxes(anchors, take(gt_boxes, best_idx))
    l1 = torch.abs(box_deltas.float() - tgt_deltas)
    box_loss = torch.where(pos[..., None], l1, 0.0).sum(dim=(1, 2)) / n_pos / 4.0
    return (cls_loss + box_loss).mean()


def nms(boxes: np.ndarray, scores: np.ndarray, iou_thr: float = 0.5,
        max_det: int = 100) -> np.ndarray:
    """Greedy NMS on the host; returns the kept indices."""
    order = np.argsort(-scores)
    keep = []
    while order.size and len(keep) < max_det:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        rest = order[1:]
        ious = box_iou(boxes[i][None], boxes[rest])[0]
        order = rest[ious <= iou_thr]
    return np.asarray(keep, np.int64)


def detector_input(p, images) -> torch.Tensor:
    """[0, 1] NHWC ``images`` (numpy or tensor) as fp32 on the critic's device."""
    dev = p["backbone"]["stem"]["conv"]["w"].device
    if isinstance(images, torch.Tensor):
        return images.to(dev, torch.float32)
    return torch.as_tensor(np.asarray(images, np.float32), device=dev)


def retinanet_detect(p, images, num_classes: int = 91, score_threshold: float = 0.05,
                     nms_thr: float = 0.5, max_det: int = 100):
    """Inference on [0, 1] NHWC ``images`` (numpy or tensor): a list of
    {boxes, scores, labels} numpy dicts per image. The network and the decode
    run on the critic's device; score selection and class-wise NMS on the host."""
    with torch.inference_mode():
        x = detector_input(p, images)
        h, w = x.shape[1:3]
        cls_out, box_out = retinanet_features(p, x)
        cls_logits, box_deltas = _flatten_outputs(cls_out, box_out, num_classes)
        probs = torch.sigmoid(cls_logits.float()).cpu().numpy()
        boxes_all = decode_boxes(on_device(anchors_for_shape, h, w, device=x.device),
                                 box_deltas.float()).cpu().numpy()
    results = []
    for b in range(x.shape[0]):
        pb, bb = probs[b], boxes_all[b]
        scores = pb.max(axis=1)
        labels = pb.argmax(axis=1)
        sel = scores > score_threshold
        bx, sc, lb = bb[sel], scores[sel], labels[sel]
        bx[:, 0::2] = np.clip(bx[:, 0::2], 0, w)
        bx[:, 1::2] = np.clip(bx[:, 1::2], 0, h)
        keep_all = []
        for c in np.unique(lb):
            idx = np.where(lb == c)[0]
            keep = nms(bx[idx], sc[idx], nms_thr, max_det)
            keep_all.extend(idx[keep].tolist())
        keep_all = np.asarray(keep_all, np.int64)
        if keep_all.size:
            keep_all = keep_all[np.argsort(-sc[keep_all])[:max_det]]
        results.append({"boxes": bx[keep_all], "scores": sc[keep_all], "labels": lb[keep_all]})
    return results


def pad_targets(gts: list[dict], max_boxes: int = 64):
    """Ragged target dicts -> padded (boxes, labels, mask) numpy arrays."""
    n = len(gts)
    boxes = np.zeros((n, max_boxes, 4), np.float32)
    labels = np.zeros((n, max_boxes), np.int64)
    mask = np.zeros((n, max_boxes), bool)
    for i, g in enumerate(gts):
        k = min(len(g["labels"]), max_boxes)
        boxes[i, :k] = np.asarray(g["boxes"], np.float32)[:k]
        labels[i, :k] = np.asarray(g["labels"], np.int64)[:k]
        mask[i, :k] = True
    return boxes, labels, mask
