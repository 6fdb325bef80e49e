"""Evaluation over a restore function (the port of
``unirestore_tpu/evalx/evaluators.py``: ``center_crop``,
``ImageRestorationEvaluator`` with its ``eval_mode`` FR, NR and ALL,
``ClassificationEvaluator``, ``SemanticSegmentationEvaluator``,
``DetectionEvaluator`` and ``MultiTaskEvaluator``).

IR protocol (eval_image_restoration.py): center-crop <= 512^2, restore [hq,
lq] (lq alone in NR), quantize to uint8 levels; in FR and ALL PSNR / SSIM,
LPIPS and FID against the target; in NR and ALL the no-reference suite
(``evalx/nr_suite.py``) on each prediction; monitor val_lq/psnr, or
val_lq/niqe in NR. Classification: center-crop <= 960 x 1664, restore [hq,
lq] with task ``cls``, quantize, top-1 accuracy (macro) of each probe.
Segmentation: the restored lq only, each probe's logits averaged over the
scales 1.0 / 0.8 / 0.6 (cv2 bilinear resizes on the host), 19-class IoU.
Multi-task: each batch to the evaluator of its ``task``; monitor
val_ir_lq/psnr. Detection: the restored lq only, quantised, the detector's
boxes scored by mAP at IoU 0.1. A probe is ``fn(images_nhwc01) -> logits`` on
numpy, a detector ``fn(images_nhwc01) -> [{boxes, scores, labels}]``.

The ``restore_fn(images_nhwc, task) -> images_nhwc`` closure takes and gives
numpy in [0, 1] (``train/engine.py:UniFIEEngine.restore_fn``).
"""

from __future__ import annotations

import copy
import os

import numpy as np

from . import metrics as M
from .task_metric import TaskMetric


def _stem(name: str) -> str:
    """fname may carry the original extension; dumps are always .png."""
    return os.path.splitext(str(name))[0]


def as_probe(apply_fn, device):
    """A probe over ``apply_fn(images) -> logits`` on tensors: fn(images_nhwc01
    numpy) -> logits float32 numpy, run in fp32 on ``device``."""
    import torch

    def run(images):
        with torch.inference_mode():
            x = torch.as_tensor(np.asarray(images, np.float32), device=device)
            return apply_fn(x).float().cpu().numpy()

    return run


def upload(images, device):
    """numpy NHWC -> an fp32 tensor on ``device``; to the card through pinned
    memory without waiting for it, so that a metric's read-back of its result
    is the one point of its call where the host waits for the card."""
    import torch

    x = torch.from_numpy(np.ascontiguousarray(images, dtype=np.float32))
    if device.type == "cuda":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


def probe(task: str, critic, device):
    """The validation probe over a critic (``tasks.critic_apply``)."""
    from ..tasks import critic_apply

    return as_probe(lambda x: critic_apply(task, critic, x), device)


def center_crop(img: np.ndarray, upper_h: int, upper_w: int) -> np.ndarray:
    """(B, H, W, C) center crop to at most (upper_h, upper_w)
    (eval_image_restoration.py:113-136)."""
    h, w = img.shape[1:3]
    ch, cw = min(h, upper_h), min(w, upper_w)
    top, left = h // 2 - ch // 2, w // 2 - cw // 2
    return img[:, top:top + ch, left:left + cw]


def _clone_metric(m):
    """A fresh-state copy that shares any underlying network (the
    NetworkSharedMultioutputWrapper semantics, task.py:30-60). PI's inner NIQE
    and NRQM are copied too: a shared NRQM would mix the hq and lq streams and
    be cleared by the first clone's reset."""
    c = copy.copy(m)
    if hasattr(c, "niqe"):
        c.niqe = copy.copy(c.niqe)
        c.niqe.reset()
    if getattr(c, "nrqm", None) is not None:
        c.nrqm = copy.copy(c.nrqm)
        c.nrqm.reset()
    if hasattr(c, "reset"):
        c.reset()
    return c


class ImageRestorationEvaluator:
    def __init__(self, restore_fn, eval_mode: str = "FR", need_crop: bool = True,
                 lpips_fn=None, fid=None, save_dir: str | None = None,
                 nr_metrics: dict | None = None):
        """``fid``: eval_type -> ``evalx.fid.FID``; ``nr_metrics``: name ->
        MeanMetric-style NR scorer (the pyiqa set, eval_image_restoration.py:
        190-203; ``evalx.nr_suite.build_nr_suite``), applied to the restored
        prediction of each eval_type, each with its own state."""
        self.restore_fn = restore_fn
        self.eval_mode = eval_mode
        self.need_crop = need_crop
        self.eval_types = ["lq"] if eval_mode == "NR" else ["hq", "lq"]
        self.task_metric = TaskMetric(self.eval_types)
        if eval_mode in ("FR", "ALL"):
            self.task_metric.add_metric("psnr", M.MeanMetric)
            self.task_metric.add_metric("ssim", M.MeanMetric)
        self.lpips_fn = lpips_fn
        if lpips_fn is not None:
            self.task_metric.add_metric("lpips", M.MeanMetric)
        self.fid = fid
        self.nr = {}
        if nr_metrics and eval_mode in ("NR", "ALL"):
            self.nr = {etype: {k: _clone_metric(v) for k, v in nr_metrics.items()}
                       for etype in self.eval_types}
        self.save_dir = save_dir  # per-image PNG dumps (reference
        # eval_image_restoration.py:84-98) into save_dir/{hq,lq}/
        self.logger = None  # optional MetricLogger for batch-0 grids
        self._batch_idx = 0

    def set_logger(self, logger, step: int = 0):
        """Attach a MetricLogger; inputs/preds of the first val batch are
        logged as image grids (eval_image_restoration.py:138-160)."""
        self.logger = logger
        self._log_step = step
        self._batch_idx = 0

    def _maybe_log_grid(self, etype, imgs, preds):
        if self.logger is None or self._batch_idx > 0:
            return
        self.logger.log_images(getattr(self, "_log_step", 0), f"val_{etype}/inputs",
                               np.clip(imgs, 0, 1))
        self.logger.log_images(getattr(self, "_log_step", 0), f"val_{etype}/preds", preds)

    def _maybe_save(self, etype, preds, fnames):
        if self.save_dir is None or fnames is None:
            return
        from PIL import Image
        d = os.path.join(self.save_dir, etype)
        os.makedirs(d, exist_ok=True)
        for img, name in zip(preds, fnames):
            arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(d, f"{_stem(name)}.png"))

    def validation_step(self, batch):
        hq = batch.get("hq")
        lq = batch["lq"]
        if self.need_crop:
            lq = center_crop(lq, 512, 512)
            if hq is not None:
                hq = center_crop(hq, 512, 512)
        inputs = {}
        if "hq" in self.eval_types and hq is not None:
            inputs["hq"] = hq
        inputs["lq"] = lq
        for etype, imgs in inputs.items():
            pred = np.asarray(self.restore_fn(imgs, "ir"), np.float32)
            pred = M.quantize_preds(pred)
            self._maybe_save(etype, pred, batch.get("fname"))
            self._maybe_log_grid(etype, imgs, pred)
            if hq is not None and self.eval_mode in ("FR", "ALL"):
                target = np.clip(hq, 0, 1).astype(np.float32)
                mm = self.task_metric.metrics[etype]
                for p, t in zip(pred, target):
                    mm["psnr"].update(M.psnr(t, p))
                    mm["ssim"].update(M.ssim(p, t))
                if self.lpips_fn is not None:
                    for v in np.asarray(self.lpips_fn(pred, target)):
                        mm["lpips"].update(float(v))
                if self.fid is not None:
                    self.fid[etype].update(pred, real=False)
                    self.fid[etype].update(target, real=True)
            for m in self.nr.get(etype, {}).values():
                m.update(pred)
        self._batch_idx += 1
        return pred

    def epoch_end(self, prefix: str = "val"):
        out = self.task_metric.compute_metrics(prefix)
        if self.fid is not None:
            for etype, fid in self.fid.items():
                out[f"{prefix}_{etype}/fid"] = fid.compute()
                # fresh fake statistics each epoch, the real ones kept
                # (torchmetrics' reset_real_features=False, evalx/fid.py)
                fid.reset(reset_real_features=False)
        for etype, metrics in self.nr.items():
            for name, m in metrics.items():
                out[f"{prefix}_{etype}/{name}"] = float(m.compute())
                m.reset()
        # monitor: PSNR (FR, ALL) or NIQE (NR), eval_image_restoration.py:104
        key = "niqe" if self.eval_mode == "NR" else "psnr"
        out["val_monitor"] = out.get(f"{prefix}_lq/{key}", 0.0)
        self.task_metric.reset_metrics()
        return out


class ClassificationEvaluator:
    def __init__(self, restore_fn, classifiers: dict, monitor: str | None = None):
        """``classifiers``: name -> fn(images_nhwc01) -> logits numpy;
        ``monitor`` the probe of val_monitor (default the first)."""
        self.restore_fn = restore_fn
        self.classifiers = classifiers
        self.monitor = monitor or (next(iter(classifiers)) if classifiers else None)
        self.eval_types = ["hq", "lq"]
        self.task_metric = TaskMetric(self.eval_types)
        for name in classifiers:
            self.task_metric.add_metric(name, M.TopKAccuracy)

    def validation_step(self, batch):
        labels = np.asarray(batch["gt"])
        for etype in self.eval_types:
            imgs = batch.get(etype)
            if imgs is None:
                continue
            imgs = center_crop(imgs, 960, 1664)
            # uint8-rounded floats before probing (eval_classification.py:67)
            pred = M.quantize_preds(np.asarray(self.restore_fn(imgs, "cls"), np.float32))
            for name, clf in self.classifiers.items():
                self.task_metric.metrics[etype][name].update(np.asarray(clf(pred)), labels)

    def epoch_end(self, prefix: str = "val"):
        out = self.task_metric.compute_metrics(prefix)
        if self.monitor is not None:
            out["val_monitor"] = out.get(f"{prefix}_lq/{self.monitor}", 0.0)
        self.task_metric.reset_metrics()
        return out


class SemanticSegmentationEvaluator:
    TTA_SCALES = (1.0, 0.8, 0.6)

    def __init__(self, restore_fn, seg_models: dict, num_classes: int = 19,
                 tta: bool = True, monitor: str | None = None, save_dir: str | None = None):
        """``seg_models``: name -> fn(images) -> logits (B, H, W, C) numpy;
        ``save_dir``: restored images and Cityscapes-palette predictions
        (eval_semantic_segmentation.py:78-88, 239-248)."""
        self.restore_fn = restore_fn
        self.seg_models = seg_models
        self.tta = tta
        self.save_dir = save_dir
        self.monitor = monitor or (next(iter(seg_models)) if seg_models else None)
        # the reference probes the restored lq only (eval_semantic_segmentation.py:36)
        self.eval_types = ["lq"]
        self.task_metric = TaskMetric(self.eval_types)
        for name in seg_models:
            self.task_metric.add_metric(name, lambda: M.ConfusionIoU(num_classes))

    def _predict_logits(self, model, imgs):
        """Scale-averaged TTA (eval_semantic_segmentation.py:220-237)."""
        import cv2
        h, w = imgs.shape[1:3]
        total = None
        scales = self.TTA_SCALES if self.tta else (1.0,)
        for s in scales:
            scaled = imgs
            if s != 1.0:
                nh, nw = int(round(h * s)), int(round(w * s))
                scaled = np.stack([cv2.resize(im, (nw, nh), interpolation=cv2.INTER_LINEAR)
                                   for im in imgs])
            logits = np.asarray(model(scaled), np.float32)
            if s != 1.0:
                logits = np.stack([cv2.resize(lg, (w, h), interpolation=cv2.INTER_LINEAR)
                                   for lg in logits])
            total = logits if total is None else total + logits
        return total / len(scales)

    def validation_step(self, batch):
        labels = np.asarray(batch["gt"])
        for etype in self.eval_types:
            imgs = batch.get(etype)
            if imgs is None:
                continue
            imgs = center_crop(imgs, 960, 1664)
            lb = labels
            if labels.shape[1:3] != imgs.shape[1:3]:
                lb = center_crop(labels[..., None], 960, 1664)[..., 0]
            pred = M.quantize_preds(np.asarray(self.restore_fn(imgs, "seg"), np.float32))
            for name, model in self.seg_models.items():
                seg = self._predict_logits(model, pred).argmax(-1)
                self.task_metric.metrics[etype][name].update(seg, lb)
                if self.save_dir and name == self.monitor:
                    self._save_seg(etype, pred, seg, batch.get("fname"))

    def _save_seg(self, etype, preds, segs, fnames):
        """Restored image and colourised prediction dumps (<save_dir>/{lq,seg})."""
        if fnames is None:
            return
        from PIL import Image

        from ..data.datasets import CITYSCAPES_TRAIN_ID_TO_COLOR as PAL
        for sub in (etype, "seg"):
            os.makedirs(os.path.join(self.save_dir, sub), exist_ok=True)
        for img, seg, name in zip(preds, segs, fnames):
            arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(self.save_dir, etype, f"{_stem(name)}.png"))
            color = PAL[np.clip(seg, 0, len(PAL) - 1)].astype(np.uint8)
            Image.fromarray(color).save(os.path.join(self.save_dir, "seg", f"{_stem(name)}.png"))

    def epoch_end(self, prefix: str = "val"):
        out = self.task_metric.compute_metrics(prefix)
        if self.monitor is not None:
            out["val_monitor"] = out.get(f"{prefix}_lq/{self.monitor}", 0.0)
        self.task_metric.reset_metrics()
        return out


class DetectionEvaluator:
    """Detection protocol (eval_detection.py; JAX ``DetectionEvaluator``,
    ``unirestore_tpu/evalx/evaluators.py:307-364``): restore the lq images with
    task ``det``, quantise to uint8 levels, run the detector and feed
    ``MeanAveragePrecision`` at the IoU thresholds given; monitor
    ``val_lq/map``."""

    def __init__(self, restore_fn, detector_fn, iou_thresholds=(0.1,),
                 save_dir: str | None = None):
        """``detector_fn(images) -> list of {boxes, scores, labels}``;
        ``save_dir``: restored images with the predicted boxes drawn
        (<save_dir>/det, eval_detection.py:84-94, 286-318)."""
        self.restore_fn = restore_fn
        self.detector_fn = detector_fn
        self.save_dir = save_dir
        self.eval_types = ["lq"]
        self.map = {t: M.MeanAveragePrecision(iou_thresholds) for t in self.eval_types}

    @staticmethod
    def _draw_boxes(img_u8, boxes, color=(255, 0, 0), width: int = 2):
        h, w = img_u8.shape[:2]
        for x0, y0, x1, y1 in np.asarray(boxes, np.int64):
            x0, x1 = np.clip([x0, x1], 0, w - 1)
            y0, y1 = np.clip([y0, y1], 0, h - 1)
            for t in range(width):
                img_u8[np.clip(y0 + t, 0, h - 1), x0:x1 + 1] = color
                img_u8[np.clip(y1 - t, 0, h - 1), x0:x1 + 1] = color
                img_u8[y0:y1 + 1, np.clip(x0 + t, 0, w - 1)] = color
                img_u8[y0:y1 + 1, np.clip(x1 - t, 0, w - 1)] = color
        return img_u8

    def _save_det(self, preds, dets, fnames):
        """PNGs through ``ops/png.py`` (the card's machine has no PIL)."""
        if self.save_dir is None or fnames is None:
            return
        from ..ops import png

        d = os.path.join(self.save_dir, "det")
        os.makedirs(d, exist_ok=True)
        for img, det, name in zip(preds, dets, fnames):
            arr = (np.clip(img, 0, 1) * 255).astype(np.uint8).copy()
            with open(os.path.join(d, f"{_stem(name)}.png"), "wb") as f:
                f.write(png.encode(self._draw_boxes(arr, det["boxes"])))

    def validation_step(self, batch):
        targets = batch["gt"] if isinstance(batch["gt"], list) else [batch["gt"]]
        pred = np.asarray(self.restore_fn(batch["lq"], "det"), np.float32)
        # uint8 quantisation before the probe, as every other evaluator
        # (eval_detection.py:74: mul(255).round_().clamp_().div_(255))
        dets = self.detector_fn(M.quantize_preds(pred))
        self.map["lq"].update(dets, targets)
        self._save_det(pred, dets, batch.get("fname"))

    def epoch_end(self, prefix: str = "val"):
        out = {f"{prefix}_lq/map": self.map["lq"].compute()}
        out["val_monitor"] = out[f"{prefix}_lq/map"]
        for m in self.map.values():
            m.reset()
        return out


class MultiTaskEvaluator:
    """Routes each val batch by its task tag (eval_multi_task.py:144-165)."""

    def __init__(self, ir_eval, cls_eval, seg_eval):
        self.evals = {"ir": ir_eval, "cls": cls_eval, "seg": seg_eval}

    def validation_step(self, batch):
        self.evals[batch["task"]].validation_step(batch)

    def epoch_end(self, prefix: str = "val"):
        out = {}
        for task, ev in self.evals.items():
            sub = ev.epoch_end(prefix=f"{prefix}_{task}")
            sub.pop("val_monitor", None)
            out.update(sub)
        # monitor = IR PSNR (eval_multi_task.py:79-95)
        out["val_monitor"] = out.get(f"{prefix}_ir_lq/psnr", 0.0)
        return out
