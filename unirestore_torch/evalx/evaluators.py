"""Evaluation over a restore function (the port of
``unirestore_tpu/evalx/evaluators.py``: ``center_crop``, the FR protocol of
``ImageRestorationEvaluator``, ``ClassificationEvaluator``,
``SemanticSegmentationEvaluator`` and ``MultiTaskEvaluator``).

IR protocol (eval_image_restoration.py): center-crop <= 512^2, restore [hq,
lq], quantize to uint8 levels, PSNR / SSIM and LPIPS against the target;
monitor val_lq/psnr. Classification: center-crop <= 960 x 1664, restore [hq,
lq] with task ``cls``, quantize, top-1 accuracy (macro) of each probe.
Segmentation: the restored lq only, each probe's logits averaged over the
scales 1.0 / 0.8 / 0.6 (cv2 bilinear resizes on the host), 19-class IoU.
Multi-task: each batch to the evaluator of its ``task``; monitor
val_ir_lq/psnr. A probe is ``fn(images_nhwc01) -> logits`` on numpy. The NR
metric suite (the JAX evaluator's ``eval_mode`` NR and ALL), FID and the
detection evaluator are not ported yet (ROADMAP Queue A 5; ``config.build``
refuses them).

The ``restore_fn(images_nhwc, task) -> images_nhwc`` closure takes and gives
numpy in [0, 1] (``train/engine.py:UniFIEEngine.restore_fn``).
"""

from __future__ import annotations

import os

import numpy as np

from . import metrics as M
from .task_metric import TaskMetric


def _stem(name: str) -> str:
    """fname may carry the original extension; dumps are always .png."""
    return os.path.splitext(str(name))[0]


def probe(task: str, critic, device):
    """The validation probe over a critic: fn(images_nhwc01 numpy) -> logits
    float32 numpy, run in fp32 on ``device`` (``tasks.critic_apply``)."""
    import torch

    from ..tasks import critic_apply

    def run(images):
        with torch.inference_mode():
            x = torch.as_tensor(np.asarray(images, np.float32), device=device)
            return critic_apply(task, critic, x).float().cpu().numpy()

    return run


def center_crop(img: np.ndarray, upper_h: int, upper_w: int) -> np.ndarray:
    """(B, H, W, C) center crop to at most (upper_h, upper_w)
    (eval_image_restoration.py:113-136)."""
    h, w = img.shape[1:3]
    ch, cw = min(h, upper_h), min(w, upper_w)
    top, left = h // 2 - ch // 2, w // 2 - cw // 2
    return img[:, top:top + ch, left:left + cw]


class ImageRestorationEvaluator:
    def __init__(self, restore_fn, need_crop: bool = True, lpips_fn=None,
                 save_dir: str | None = None):
        self.restore_fn = restore_fn
        self.need_crop = need_crop
        self.eval_types = ["hq", "lq"]
        self.task_metric = TaskMetric(self.eval_types)
        self.task_metric.add_metric("psnr", M.MeanMetric)
        self.task_metric.add_metric("ssim", M.MeanMetric)
        self.lpips_fn = lpips_fn
        if lpips_fn is not None:
            self.task_metric.add_metric("lpips", M.MeanMetric)
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
        if hq is not None:
            inputs["hq"] = hq
        inputs["lq"] = lq
        for etype, imgs in inputs.items():
            pred = np.asarray(self.restore_fn(imgs, "ir"), np.float32)
            pred = M.quantize_preds(pred)
            self._maybe_save(etype, pred, batch.get("fname"))
            self._maybe_log_grid(etype, imgs, pred)
            if hq is not None:
                target = np.clip(hq, 0, 1).astype(np.float32)
                mm = self.task_metric.metrics[etype]
                for p, t in zip(pred, target):
                    mm["psnr"].update(M.psnr(t, p))
                    mm["ssim"].update(M.ssim(p, t))
                if self.lpips_fn is not None:
                    for v in np.asarray(self.lpips_fn(pred, target)):
                        mm["lpips"].update(float(v))
        self._batch_idx += 1
        return pred

    def epoch_end(self, prefix: str = "val"):
        out = self.task_metric.compute_metrics(prefix)
        # monitor: PSNR (FR) — eval_image_restoration.py:104
        out["val_monitor"] = out.get(f"{prefix}_lq/psnr", 0.0)
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
