"""Image-restoration evaluation over a restore function (the port of
``unirestore_tpu/evalx/evaluators.py``: ``center_crop`` and
``ImageRestorationEvaluator``, the FR protocol only).

IR protocol (eval_image_restoration.py): center-crop <= 512^2, restore [hq,
lq], quantize to uint8 levels, PSNR / SSIM and LPIPS against the target;
monitor val_lq/psnr. The NR metric suite (the JAX evaluator's ``eval_mode``
NR and ALL), FID and the classification, segmentation, detection and
multi-task evaluators are not ported yet (ROADMAP Queue A 5;
``config.build`` refuses them).

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
