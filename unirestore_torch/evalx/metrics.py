"""Image quality metrics with skimage-exact conventions.

The port's own copy of ``unirestore_tpu/evalx/metrics.py`` (numpy only; the port imports
nothing of the JAX package).

The reference computes PSNR/SSIM per-image on CPU via scikit-image
(eval_image_restoration.py:255-313) after quantizing predictions to uint8
levels (``mul(255).round().clamp(0,255).div(255)``, :71). We reproduce:

- PSNR: 10*log10(range^2 / MSE) in float64 over all channels
- SSIM: 7x7 uniform filter, K1=.01 K2=.03, unbiased covariance, valid-region
  crop, per-channel then channel mean (skimage structural_similarity
  defaults with channel_axis)
- mIoU: 19-class confusion-matrix IoU with ignore_index 255
- top-1 accuracy; mAP at a fixed IoU threshold (torchmetrics
  MeanAveragePrecision(iou_thresholds=[0.1]) semantics, 101-pt interp)
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter


def quantize_preds(x: np.ndarray) -> np.ndarray:
    """uint8-level rounding (eval_image_restoration.py:71)."""
    return np.clip(np.round(x * 255.0), 0, 255) / 255.0


def psnr(target: np.ndarray, pred: np.ndarray, data_range: float = 1.0):
    t = target.astype(np.float64)
    p = pred.astype(np.float64)
    mse = np.mean((t - p) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10((data_range ** 2) / mse)


def ssim(pred: np.ndarray, target: np.ndarray, data_range: float = 1.0,
         win_size: int = 7, k1: float = 0.01, k2: float = 0.03):
    """Channel-last HWC (or HW) SSIM, skimage default conventions."""
    p = pred.astype(np.float64)
    t = target.astype(np.float64)
    if p.ndim == 3:
        return float(np.mean([ssim(p[..., c], t[..., c], data_range, win_size,
                                   k1, k2) for c in range(p.shape[-1])]))
    np_ = win_size ** 2
    cov_norm = np_ / (np_ - 1)

    def f(a):
        return uniform_filter(a, size=win_size, mode="reflect")

    ux, uy = f(p), f(t)
    uxx, uyy, uxy = f(p * p), f(t * t), f(p * t)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    a1, a2 = 2 * ux * uy + c1, 2 * vxy + c2
    b1, b2 = ux ** 2 + uy ** 2 + c1, vx + vy + c2
    s = (a1 * a2) / (b1 * b2)
    pad = (win_size - 1) // 2
    return float(s[pad:-pad, pad:-pad].mean())


class MeanMetric:
    """sum/count accumulator with cross-process reduction via psum-style
    merge (torchmetrics dist_reduce_fx='sum' equivalent)."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.total += float(value) * n if n > 1 else float(value)
        self.count += n

    def compute(self):
        return self.total / max(self.count, 1)

    def reset(self):
        self.total, self.count = 0.0, 0

    def merge(self, other: "MeanMetric"):
        self.total += other.total
        self.count += other.count


class ConfusionIoU:
    """mIoU over a confusion matrix (eval_semantic_segmentation.py:253-292;
    MulticlassJaccardIndex(ignore_index=255) semantics: classes absent from
    both target and prediction are excluded from the mean)."""

    def __init__(self, num_classes: int = 19, ignore_index: int = 255):
        self.n = num_classes
        self.ignore = ignore_index
        self.mat = np.zeros((num_classes, num_classes), np.int64)

    def update(self, pred: np.ndarray, target: np.ndarray):
        mask = target != self.ignore
        p = pred[mask].astype(np.int64)
        t = target[mask].astype(np.int64)
        idx = t * self.n + p
        self.mat += np.bincount(idx, minlength=self.n * self.n).reshape(
            self.n, self.n)

    def merge(self, other: "ConfusionIoU"):
        self.mat += other.mat

    def compute(self):
        inter = np.diag(self.mat).astype(np.float64)
        union = self.mat.sum(0) + self.mat.sum(1) - np.diag(self.mat)
        present = union > 0
        iou = np.where(present, inter / np.maximum(union, 1), 0.0)
        return float(iou[present].mean()) if present.any() else 0.0

    def per_class(self):
        inter = np.diag(self.mat).astype(np.float64)
        union = self.mat.sum(0) + self.mat.sum(1) - np.diag(self.mat)
        return inter / np.maximum(union, 1)

    def reset(self):
        self.mat[:] = 0


class TopKAccuracy:
    """Top-k accuracy with torchmetrics ``MulticlassAccuracy`` semantics.

    The reference wraps ``MulticlassAccuracy(num_classes, top_k=1)``
    (eval_classification.py:278-282) whose DEFAULT average is "macro":
    per-class recall averaged over the classes that appear in the targets
    (torchmetrics 1.4 ``_adjust_weights_safe_divide`` weights classes by
    support > 0). ``average="micro"`` gives plain correct/total.
    """

    def __init__(self, k: int = 1, average: str = "macro"):
        self.k = k
        self.average = average
        self.reset()

    def update(self, logits: np.ndarray, labels: np.ndarray):
        topk = np.argsort(-logits, axis=-1)[:, :self.k]
        hit = (topk == labels[:, None]).any(axis=1)
        for label, h in zip(labels.astype(int), hit):
            c, t = self.per_class.get(int(label), (0, 0))
            self.per_class[int(label)] = (c + int(h), t + 1)

    def compute(self):
        if not self.per_class:
            return 0.0
        if self.average == "micro":
            correct = sum(c for c, _ in self.per_class.values())
            total = sum(t for _, t in self.per_class.values())
            return correct / max(total, 1)
        return float(np.mean([c / t for c, t in self.per_class.values()]))

    def reset(self):
        self.per_class = {}  # label -> (correct, total)

    def merge(self, other: "TopKAccuracy"):
        for label, (c, t) in other.per_class.items():
            c0, t0 = self.per_class.get(label, (0, 0))
            self.per_class[label] = (c0 + c, t0 + t)


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4) x (M,4) xyxy IoU matrix."""
    area_a = np.maximum(a[:, 2] - a[:, 0], 0) * np.maximum(a[:, 3] - a[:, 1], 0)
    area_b = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(b[:, 3] - b[:, 1], 0)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-9)


class MeanAveragePrecision:
    """COCO-style mAP at fixed IoU threshold(s), 101-point interpolation
    (torchmetrics MeanAveragePrecision(iou_thresholds=[0.1]) as used at
    eval_detection.py:38)."""

    def __init__(self, iou_thresholds=(0.1,)):
        self.thresholds = list(iou_thresholds)
        self.preds = []  # (boxes, scores, labels) per image
        self.targets = []  # (boxes, labels) per image

    def update(self, preds: list[dict], targets: list[dict]):
        for p, t in zip(preds, targets):
            self.preds.append((np.asarray(p["boxes"], np.float64).reshape(-1, 4),
                               np.asarray(p["scores"], np.float64),
                               np.asarray(p["labels"], np.int64)))
            self.targets.append((np.asarray(t["boxes"],
                                            np.float64).reshape(-1, 4),
                                 np.asarray(t["labels"], np.int64)))

    def merge(self, other: "MeanAveragePrecision"):
        self.preds.extend(other.preds)
        self.targets.extend(other.targets)

    def _ap_for_class(self, cls: int, thr: float):
        scores, matches, n_gt = [], [], 0
        for (pb, ps, pl), (tb, tl) in zip(self.preds, self.targets):
            gt = tb[tl == cls]
            n_gt += len(gt)
            sel = pl == cls
            boxes, scr = pb[sel], ps[sel]
            order = np.argsort(-scr)
            boxes, scr = boxes[order], scr[order]
            taken = np.zeros(len(gt), bool)
            for b, s in zip(boxes, scr):
                scores.append(s)
                if len(gt) == 0:
                    matches.append(False)
                    continue
                ious = box_iou(b[None], gt)[0]
                ious[taken] = -1
                j = int(np.argmax(ious))
                if ious[j] >= thr:
                    matches.append(True)
                    taken[j] = True
                else:
                    matches.append(False)
        if n_gt == 0:
            return None
        if not scores:
            return 0.0
        order = np.argsort(-np.asarray(scores))
        m = np.asarray(matches, np.float64)[order]
        tp = np.cumsum(m)
        fp = np.cumsum(1 - m)
        recall = tp / n_gt
        precision = tp / np.maximum(tp + fp, 1e-9)
        # 101-point interpolated AP (COCO)
        prec_at = np.zeros(101)
        for i, r in enumerate(np.linspace(0, 1, 101)):
            mask = recall >= r
            prec_at[i] = precision[mask].max() if mask.any() else 0.0
        return float(prec_at.mean())

    def compute(self):
        classes = sorted({int(c) for _, l in self.targets for c in l})
        aps = []
        for thr in self.thresholds:
            for c in classes:
                ap = self._ap_for_class(c, thr)
                if ap is not None:
                    aps.append(ap)
        return float(np.mean(aps)) if aps else 0.0

    def reset(self):
        self.preds, self.targets = [], []
