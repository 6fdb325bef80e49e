"""Manifest (.list) parsing.

The port's own copy of ``unirestore_tpu/data/manifest.py`` (numpy only; the port imports
nothing of the JAX package).

The reference datasets consume whitespace-separated ``.list`` manifests:
``"lq hq ann"`` per line ('None' -> missing), sorted; FoggyCityscapes rows
have 5 fields ``"fog1 fog2 fog3 clean label"`` (reference:
dataset_ir.py:24-53, dataset_seg.py:23-56).
"""

from __future__ import annotations

import os


class ImageData:
    """Sorted record list from a manifest file. Each record is the raw field
    tuple; interpretation is dataset-specific."""

    def __init__(self, listfile: str):
        self.listfile = listfile
        with open(listfile) as fin:
            self.records = sorted(
                tuple(line.strip().split()) for line in fin if line.strip())

    def __len__(self):
        return len(self.records)

    def __getitem__(self, index: int):
        return self.records[index]


def parse_triplet(record):
    """(lq, hq, ann, fname) with 'None' -> None."""
    lq, hq, ann = (list(record) + [None, None, None])[:3]
    lq = None if lq in (None, "None") else lq
    hq = None if hq in (None, "None") else hq
    ann = None if ann in (None, "None") else ann
    fname = os.path.basename(hq or lq or "")
    return lq, hq, ann, fname


# task-keyed manifest registry (reference data/__init__.py:23-57)
DATASET_DICT = {
    "ImageNet": {"train": "./dataset/Classification/ImageNet/train.list",
                 "val": "./dataset/Classification/ImageNet/val.list"},
    "CUB": {"val": "./dataset/Classification/CUB/val.list"},
    "Cityscapes": {"train": "./dataset/Segmentation/Cityscapes/train.list",
                   "val": "./dataset/Segmentation/Cityscapes/val.list"},
    "FoggyCityscapes": {
        "train": "./dataset/Segmentation/FoggyCityscapes/train.list",
        "val": "./dataset/Segmentation/FoggyCityscapes/val.list"},
    "Foggy_Zurich": {"val": "./dataset/Segmentation/Foggy_Zurich/val.list"},
    "ACDC": {"train": "./dataset/Segmentation/ACDC/train.list",
             "val_fog": "./dataset/Segmentation/ACDC/val_fog.list",
             "val_rain": "./dataset/Segmentation/ACDC/val_rain.list",
             "val_snow": "./dataset/Segmentation/ACDC/val_snow.list",
             "val_night": "./dataset/Segmentation/ACDC/val_night.list",
             "val": "./dataset/Segmentation/ACDC/val.list"},
    "COCO": {"train": "./dataset/Detection/COCO/train.list",
             "val": "./dataset/Detection/COCO/val.list",
             "test": "./dataset/Detection/COCO/test.list"},
    "RTTS": {"test": "./dataset/Detection/RTTS/test.list"},
    "DIVF2KOST": {"train": "./dataset/PIR/DIVF2KOST/train.list",
                  "val": "./dataset/PIR/DIVF2KOST/val.list"},
}
