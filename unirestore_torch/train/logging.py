"""Experiment logging: JSONL always, TensorBoard when it imports.

The port of ``unirestore_tpu/train/logging.py``: the same ``metrics.jsonl``
records (one JSON object per call: ``step``, ``time`` and the scalars) in
``<log_dir>/<name>/``. TensorBoard event files go beside them through
``torch.utils.tensorboard`` when that imports, as the JAX file writes them
through TensorFlow when TensorFlow is present; without it the logger writes
JSONL only, and images as PNG files under ``images/``.

Reference counterpart: Lightning TensorBoardLogger + self.log/log_dict
(train_stage1.yaml:27-32, engine_unifie.py:158-166) and the image grids
logged at batch_idx==0 (eval_image_restoration.py:138-160).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


class MetricLogger:
    def __init__(self, log_dir: str, name: str = "run", use_tensorboard: bool = True):
        self.dir = os.path.join(log_dir, name)
        os.makedirs(self.dir, exist_ok=True)
        self.jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        self.tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass
            else:
                self.tb = SummaryWriter(self.dir)

    def log_scalars(self, step: int, scalars: dict):
        rec = {"step": int(step), "time": time.time(),
               **{k: float(v) for k, v in scalars.items()}}
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(k, float(v), global_step=step)
            self.tb.flush()

    def log_images(self, step: int, tag: str, images):
        """images: (N, H, W, C) float [0,1]."""
        arr = np.clip(np.asarray(images), 0, 1)
        if self.tb is not None:
            self.tb.add_images(tag, arr, global_step=step, dataformats="NHWC")
            self.tb.flush()
        else:
            from PIL import Image
            d = os.path.join(self.dir, "images")
            os.makedirs(d, exist_ok=True)
            for i, im in enumerate(arr):
                Image.fromarray((im * 255).astype("uint8")).save(
                    os.path.join(d, f"{tag.replace('/', '_')}_{step}_{i}.png"))

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


class NullLogger:
    """The logger of a data-parallel rank other than 0: it writes nothing, so
    that rank 0 alone writes the run's files."""

    def log_scalars(self, step: int, scalars: dict):
        pass

    def log_images(self, step: int, tag: str, images):
        pass

    def close(self):
        pass
