"""Detection datasets (COCO-style JSON-per-image annotations, RTTS remap).

The port's own copy of ``unirestore_tpu/data/datasets_det.py`` (numpy only; the port imports
nothing of the JAX package).

Reference: dataset_det.py — VOC-style json records (``object*`` ->
bndbox/name), COCO 91-slot class table, RTTS 5-class -> COCO-id mapping,
box-aware train augmentation (random resize ratio ~[0.8, 1.3] with a floor so
the crop fits, hflip with box flip, re-crop until >= 1 box survives).
Labels stay host-side ragged dicts {"boxes": (N,4) xyxy, "labels": (N,)}.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .datasets import (_Base, _rand_crop_params, _resize_to, _to_float,
                       degrade_image, load_image, pick_corruption)

COCO_CLASSES = (
    "__background__", "person", "bicycle", "car", "motorcycle", "airplane",
    "bus", "train", "truck", "boat", "traffic light", "fire hydrant", "N/A",
    "stop sign", "parking meter", "bench", "bird", "cat", "dog", "horse",
    "sheep", "cow", "elephant", "bear", "zebra", "giraffe", "N/A", "backpack",
    "umbrella", "N/A", "N/A", "handbag", "tie", "suitcase", "frisbee", "skis",
    "snowboard", "sports ball", "kite", "baseball bat", "baseball glove",
    "skateboard", "surfboard", "tennis racket", "bottle", "N/A", "wine glass",
    "cup", "fork", "knife", "spoon", "bowl", "banana", "apple", "sandwich",
    "orange", "broccoli", "carrot", "hot dog", "pizza", "donut", "cake",
    "chair", "couch", "potted plant", "bed", "N/A", "dining table", "N/A",
    "N/A", "toilet", "N/A", "tv", "laptop", "mouse", "remote", "keyboard",
    "cell phone", "microwave", "oven", "toaster", "sink", "refrigerator",
    "N/A", "book", "clock", "vase", "scissors", "teddy bear", "hair drier",
    "toothbrush",
)
COCO_NAME_TO_ID = {n: i for i, n in enumerate(COCO_CLASSES)}
# RTTS's 5 classes mapped onto COCO ids (dataset_det.py RTTSclass2CoCoids)
RTTS_NAME_TO_COCO_ID = {"person": 1, "bicycle": 2, "car": 3, "bus": 6,
                        "motorbike": 4}


def load_det_annotation(ann_path: str, mapping: dict) -> dict:
    """Parse the VOC-style JSON: keys containing 'object' carry
    bndbox/name."""
    boxes, labels = [], []
    with open(ann_path) as f:
        data = json.load(f)
    for k, v in data.items():
        if "object" in k:
            bb = v["bndbox"]
            if bb["xmax"] > bb["xmin"] and bb["ymax"] > bb["ymin"]:
                boxes.append([bb["xmin"], bb["ymin"], bb["xmax"], bb["ymax"]])
                labels.append(mapping[v["name"]])
    return {"boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray(labels, np.int64)}


def _aug_boxes(rng, hq, lq, label, resolution):
    """Box-aware resize+flip+crop (dataset_det.py pair_aug_transform)."""
    import cv2
    h, w = hq.shape[:2]
    min_ratio = 0.8
    if min(h, w) * min_ratio < resolution:
        min_ratio = resolution / min(h, w) + 0.1
    rw = rng.uniform(max(min_ratio, 0.8), max(min_ratio, 1.3))
    rh = rng.uniform(max(min_ratio, 0.8), max(min_ratio, 1.3))
    nh, nw = int(h * rh), int(w * rw)
    hq = cv2.resize(hq, (nw, nh), interpolation=cv2.INTER_CUBIC)
    lq = cv2.resize(lq, (nw, nh), interpolation=cv2.INTER_CUBIC)
    boxes = label["boxes"] * np.array([rw, rh, rw, rh], np.float32)

    if rng.uniform() > 0.5:
        hq, lq = hq[:, ::-1], lq[:, ::-1]
        x0 = nw - boxes[:, 2] - 1
        x1 = nw - boxes[:, 0] - 1
        boxes = np.stack([x0, boxes[:, 1], x1, boxes[:, 3]], axis=1)

    # re-crop until at least one box survives
    for _ in range(100):
        i, j, ch, cw = _rand_crop_params(rng, nh, nw, resolution)
        shifted = boxes - np.array([j, i, j, i], np.float32)
        keep = ((shifted[:, 0] < cw) & (shifted[:, 1] < ch)
                & (shifted[:, 2] > 0) & (shifted[:, 3] > 0)
                & (shifted[:, 2] > shifted[:, 0])
                & (shifted[:, 3] > shifted[:, 1]))
        if keep.any():
            clipped = shifted[keep]
            clipped[:, 0] = np.clip(clipped[:, 0], 0, cw)
            clipped[:, 1] = np.clip(clipped[:, 1], 0, ch)
            clipped[:, 2] = np.clip(clipped[:, 2], 0, cw)
            clipped[:, 3] = np.clip(clipped[:, 3], 0, ch)
            return (np.ascontiguousarray(hq[i:i + ch, j:j + cw]),
                    np.ascontiguousarray(lq[i:i + ch, j:j + cw]),
                    {"boxes": clipped, "labels": label["labels"][keep]})
    # fallback (no random crop hit a box in 100 tries): take the top-left
    # crop and apply the SAME filter+clip the loop applies — the raw label
    # dict would leak boxes outside the crop (and hflip's shifted coords)
    # into the training targets
    keep = ((boxes[:, 0] < resolution) & (boxes[:, 1] < resolution)
            & (boxes[:, 2] > 0) & (boxes[:, 3] > 0)
            & (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1]))
    clipped = np.clip(boxes[keep], 0, resolution).astype(np.float32)
    return (hq[:resolution, :resolution], lq[:resolution, :resolution],
            {"boxes": clipped, "labels": label["labels"][keep]})


class CoCoCorruptDataset(_Base):
    def __init__(self, *args, ann: str = "CoCo", **kwargs):
        super().__init__(*args, **kwargs)
        self.mapping = (COCO_NAME_TO_ID if ann == "CoCo"
                        else RTTS_NAME_TO_COCO_ID)

    def __getitem__(self, index: int, epoch: int = 0):
        rng = self.rng(index, epoch)
        rec = self.dataset[index]
        hq_p, ann_p = rec[1], rec[2]
        fname = os.path.basename(hq_p)
        hq = load_image(hq_p)
        lq = hq.copy()
        label = load_det_annotation(ann_p, self.mapping)
        if len(label["boxes"]) == 0:
            raise KeyError(f"{ann_p} has no valid annotation")
        if self.is_train:
            hq, lq, label = _aug_boxes(rng, hq, lq, label, self.resolution)
        mode, severity = pick_corruption(rng, self.corruption_funcs)
        lq = degrade_image(rng, np.ascontiguousarray(lq), mode, severity,
                           self.resolution)
        return {"lq": _to_float(lq), "hq": _to_float(hq), "gt": label,
                "fname": fname, "task": "det"}


class CoCoPairDataset(_Base):
    def __init__(self, *args, ann: str = "CoCo", **kwargs):
        super().__init__(*args, **kwargs)
        self.mapping = (COCO_NAME_TO_ID if ann == "CoCo"
                        else RTTS_NAME_TO_COCO_ID)

    def __getitem__(self, index: int, epoch: int = 0):
        rec = self.dataset[index]
        lq_p, hq_p, ann_p = rec[0], rec[1], rec[2]
        hq = load_image(hq_p) if hq_p not in (None, "None") else None
        lq = load_image(lq_p) if lq_p not in (None, "None") else hq.copy()
        if hq is None:
            hq = lq.copy()
        label = load_det_annotation(ann_p, self.mapping)
        fname = os.path.basename(hq_p if hq_p not in (None, "None") else lq_p)
        return {"lq": _to_float(lq), "hq": _to_float(hq), "gt": label,
                "fname": fname, "task": "det"}


class CoCoRealDataset(_Base):
    def __init__(self, *args, ann: str = "RTTS", **kwargs):
        super().__init__(*args, **kwargs)
        self.mapping = (COCO_NAME_TO_ID if ann == "CoCo"
                        else RTTS_NAME_TO_COCO_ID)

    def __getitem__(self, index: int, epoch: int = 0):
        rec = self.dataset[index]
        lq_p, ann_p = rec[0], rec[2]
        lq = load_image(lq_p)
        label = load_det_annotation(ann_p, self.mapping)
        return {"lq": _to_float(lq), "hq": None, "gt": label,
                "fname": os.path.basename(lq_p), "task": "det"}
