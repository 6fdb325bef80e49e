"""Per-task dataset classes (host-side numpy, NHWC, [0,1] float32).

The port's own copy of ``unirestore_tpu/data/datasets.py`` (numpy only; the port imports
nothing of the JAX package).

Re-implements the reference's dataset behaviors (dataset_ir.py,
dataset_cls.py, dataset_seg.py) on numpy/cv2/PIL:

- synchronized random-crop + hflip pair augmentation for training
- on-the-fly corruption of clean images: random short-edge resize to
  [res//4, res), corrupt, resize back (dataset_ir.py:202-230), severity
  sampled 1..5 with p = [.05, .25, .4, .25, .05]
- Cityscapes 34 -> 19 train-id label encoding + color palette
- FoggyCityscapes rows pick per-sample from {randcorrupt, fog1, fog2, fog3}

Samples are dicts: {"lq", "hq": float32 HWC, "gt": task label or None,
"fname": str, "task": str}.
"""

from __future__ import annotations

import numpy as np
from PIL import Image

from .corruption import corrupt, init_corruption_function
from .manifest import ImageData, parse_triplet

SEVERITY_P = (0.05, 0.25, 0.4, 0.25, 0.05)


def load_image(path: str) -> np.ndarray:
    """uint8 HWC RGB."""
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def load_mask(path: str) -> np.ndarray:
    """uint8 HW (single channel label image)."""
    with Image.open(path) as im:
        arr = np.asarray(im)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr


def _resize_short_edge(img: np.ndarray, size: int, nearest=False) -> np.ndarray:
    import cv2
    h, w = img.shape[:2]
    if h <= w:
        nh, nw = size, max(1, round(w * size / h))
    else:
        nh, nw = max(1, round(h * size / w)), size
    interp = cv2.INTER_NEAREST if nearest else cv2.INTER_CUBIC
    return cv2.resize(img, (nw, nh), interpolation=interp)


def _resize_to(img: np.ndarray, hw, nearest=False) -> np.ndarray:
    import cv2
    interp = cv2.INTER_NEAREST if nearest else cv2.INTER_CUBIC
    return cv2.resize(img, (hw[1], hw[0]), interpolation=interp)


def _rand_crop_params(rng, h, w, size):
    th = min(size, h)
    tw = min(size, w)
    i = int(rng.integers(0, h - th + 1))
    j = int(rng.integers(0, w - tw + 1))
    return i, j, th, tw


def _to_float(img: np.ndarray) -> np.ndarray:
    return img.astype(np.float32) / 255.0


def degrade_image(rng, hq_u8: np.ndarray, corruption_mode: str, severity: int,
                  resolution: int) -> np.ndarray:
    """Random short-edge downscale -> corrupt -> upscale back
    (dataset_ir.py:202-230)."""
    if corruption_mode == "clean":
        return hq_u8
    h, w = hq_u8.shape[:2]
    size = int(rng.integers(resolution // 4, resolution))
    lq = _resize_short_edge(hq_u8, size)
    # per-sample generator installed thread-locally: deterministic AND safe
    # under multi-threaded loaders (no global-RNG interleaving)
    lq = corrupt(lq, severity=severity, corruption_name=corruption_mode,
                 rng=rng)
    return _resize_to(lq, (h, w))


def pick_corruption(rng, funcs):
    mode = funcs[int(rng.integers(0, len(funcs)))]
    severity = int(rng.choice(5, p=SEVERITY_P)) + 1
    return mode, severity


class _Base:
    task = "ir"

    def __init__(self, dataset: ImageData, resolution: int = 512,
                 is_train: bool = True, crp_mode: str = "common", seed: int = 0):
        self.dataset = dataset
        self.resolution = resolution
        self.is_train = is_train
        # None = never corrupt; fog1/2/3 are fog-LEVEL selectors consumed
        # by the Cityscapes datasets (not corruption subsets; dataset_seg.py
        # val protocol) and also mean "no random corruption". Any other
        # string is validated by init_corruption_function: an unknown mode
        # must fail HERE with a clear message, not as an opaque
        # rng.integers(0, 0) in a worker.
        if crp_mode is None or crp_mode in ("fog1", "fog2", "fog3"):
            self.corruption_funcs = []
        else:
            self.corruption_funcs = init_corruption_function(crp_mode)
        self.crp_mode = crp_mode
        self._seed = seed

    def __len__(self):
        return len(self.dataset)

    def rng(self, index: int, epoch: int = 0):
        """Per-sample deterministic RNG (reproducible across workers)."""
        return np.random.default_rng(
            (self._seed * 1_000_003 + epoch * 7_919 + index) & 0x7FFFFFFF)


# ---------------------------------------------------------------------------
# image restoration
# ---------------------------------------------------------------------------


class IRPairDataset(_Base):
    """Paired lq/hq with synchronized train augmentation
    (dataset_ir.py:107-155)."""

    def __getitem__(self, index: int, epoch: int = 0):
        rng = self.rng(index, epoch)
        lq_p, hq_p, _, fname = parse_triplet(self.dataset[index])
        hq = load_image(hq_p)
        lq = load_image(lq_p)
        if self.is_train:
            if min(hq.shape[:2]) < self.resolution:
                hq = _resize_short_edge(hq, self.resolution)
                lq = _resize_short_edge(lq, self.resolution)
            i, j, th, tw = _rand_crop_params(rng, *hq.shape[:2],
                                             self.resolution)
            hq, lq = hq[i:i + th, j:j + tw], lq[i:i + th, j:j + tw]
            if rng.uniform() > 0.5:
                hq, lq = hq[:, ::-1], lq[:, ::-1]
        return {"lq": _to_float(lq), "hq": _to_float(hq), "gt": None,
                "fname": fname, "task": "ir"}


class IRCorruptDataset(_Base):
    """Clean images corrupted on the fly (dataset_ir.py:157-233)."""

    def __getitem__(self, index: int, epoch: int = 0):
        rng = self.rng(index, epoch)
        _, hq_p, _, fname = parse_triplet(self.dataset[index])
        hq = load_image(hq_p)
        if self.is_train:
            if min(hq.shape[:2]) < self.resolution:
                hq = _resize_short_edge(hq, self.resolution)
            i, j, th, tw = _rand_crop_params(rng, *hq.shape[:2],
                                             self.resolution)
            hq = hq[i:i + th, j:j + tw]
            if rng.uniform() > 0.5:
                hq = hq[:, ::-1]
        mode, severity = pick_corruption(rng, self.corruption_funcs)
        lq = degrade_image(rng, np.ascontiguousarray(hq), mode, severity,
                           self.resolution)
        return {"lq": _to_float(lq), "hq": _to_float(hq), "gt": None,
                "fname": fname, "task": "ir"}


class IRRealDataset(_Base):
    """lq-only real-degradation data (dataset_ir.py:56-105)."""

    def __getitem__(self, index: int, epoch: int = 0):
        rng = self.rng(index, epoch)
        lq_p, _, _, fname = parse_triplet(self.dataset[index])
        lq = load_image(lq_p)
        if self.is_train:
            if min(lq.shape[:2]) < self.resolution:
                lq = _resize_short_edge(lq, self.resolution)
            i, j, th, tw = _rand_crop_params(rng, *lq.shape[:2],
                                             self.resolution)
            lq = lq[i:i + th, j:j + tw]
            if rng.uniform() > 0.5:
                lq = lq[:, ::-1]
        return {"lq": _to_float(lq), "hq": None, "gt": None, "fname": fname,
                "task": "ir"}


class IRNoiseDataset(_Base):
    """AWGN sigma in {15, 25, 50} on clean images (dataset_ir.py:235-306)."""

    def __init__(self, *args, noise_sigma=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.sigmas = [noise_sigma] if noise_sigma else [15, 25, 50]

    def __getitem__(self, index: int, epoch: int = 0):
        rng = self.rng(index, epoch)
        _, hq_p, _, fname = parse_triplet(self.dataset[index])
        hq = load_image(hq_p)
        sigma = int(rng.choice(self.sigmas))
        noise = rng.normal(size=hq.shape)
        lq = np.clip(hq.astype(np.float32) + sigma * noise, 0,
                     255).astype(np.uint8)
        if self.is_train:
            if min(hq.shape[:2]) < self.resolution:
                hq = _resize_short_edge(hq, self.resolution)
                lq = _resize_short_edge(lq, self.resolution)
            i, j, th, tw = _rand_crop_params(rng, *hq.shape[:2],
                                             self.resolution)
            hq, lq = hq[i:i + th, j:j + tw], lq[i:i + th, j:j + tw]
            if rng.uniform() > 0.5:
                hq, lq = hq[:, ::-1], lq[:, ::-1]
        return {"lq": _to_float(lq), "hq": _to_float(hq), "gt": None,
                "fname": fname, "task": "ir"}


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------


class CLSCorruptDataset(_Base):
    """ImageNet-style: always short-edge resize to resolution before (train)
    crop; label is the int class id (dataset_cls.py:129-148)."""

    def __getitem__(self, index: int, epoch: int = 0):
        rng = self.rng(index, epoch)
        _, hq_p, ann, fname = parse_triplet(self.dataset[index])
        hq = load_image(hq_p)
        hq = _resize_short_edge(hq, self.resolution)
        if self.is_train:
            i, j, th, tw = _rand_crop_params(rng, *hq.shape[:2],
                                             self.resolution)
            hq = hq[i:i + th, j:j + tw]
            if rng.uniform() > 0.5:
                hq = hq[:, ::-1]
        mode, severity = pick_corruption(rng, self.corruption_funcs)
        lq = degrade_image(rng, np.ascontiguousarray(hq), mode, severity,
                           self.resolution)
        return {"lq": _to_float(lq), "hq": _to_float(hq),
                "gt": np.int64(ann), "fname": fname, "task": "cls"}


class CLSPairDataset(_Base):
    def __getitem__(self, index: int, epoch: int = 0):
        rng = self.rng(index, epoch)
        lq_p, hq_p, ann, fname = parse_triplet(self.dataset[index])
        hq = load_image(hq_p)
        lq = load_image(lq_p) if lq_p else hq.copy()
        hq = _resize_short_edge(hq, self.resolution)
        lq = _resize_short_edge(lq, self.resolution)
        if self.is_train:
            i, j, th, tw = _rand_crop_params(rng, *hq.shape[:2],
                                             self.resolution)
            hq, lq = hq[i:i + th, j:j + tw], lq[i:i + th, j:j + tw]
            if rng.uniform() > 0.5:
                hq, lq = hq[:, ::-1], lq[:, ::-1]
        return {"lq": _to_float(lq), "hq": _to_float(hq),
                "gt": np.int64(ann), "fname": fname, "task": "cls"}


class CLSRealDataset(_Base):
    def __getitem__(self, index: int, epoch: int = 0):
        lq_p, _, ann, fname = parse_triplet(self.dataset[index])
        lq = _resize_short_edge(load_image(lq_p), self.resolution)
        return {"lq": _to_float(lq), "hq": None,
                "gt": np.int64(ann) if ann is not None else None,
                "fname": fname, "task": "cls"}


# ---------------------------------------------------------------------------
# segmentation (Cityscapes)
# ---------------------------------------------------------------------------

# 34-class id -> 19 train ids (255 = ignore), cityscapesScripts convention
CITYSCAPES_ID_TO_TRAIN_ID = np.array([
    255, 255, 255, 255, 255, 255, 255, 0, 1, 255, 255, 2, 3, 4, 255, 255,
    255, 5, 255, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 255, 255, 16, 17, 18,
], dtype=np.uint8)

CITYSCAPES_TRAIN_ID_TO_COLOR = np.array([
    (128, 64, 128), (244, 35, 232), (70, 70, 70), (102, 102, 156),
    (190, 153, 153), (153, 153, 153), (250, 170, 30), (220, 220, 0),
    (107, 142, 35), (152, 251, 152), (70, 130, 180), (220, 20, 60),
    (255, 0, 0), (0, 0, 142), (0, 0, 70), (0, 60, 100), (0, 80, 100),
    (0, 0, 230), (119, 11, 32), (0, 0, 0),
], dtype=np.uint8)


# 256-entry LUT: ids 0-33 map per the Cityscapes table; anything else
# (notably 255 in ACDC/trainId-format masks) is IGNORE (255), not clipped
# onto id 33 ('bicycle')
_CITYSCAPES_LUT = np.full(256, 255, np.uint8)
_CITYSCAPES_LUT[:34] = CITYSCAPES_ID_TO_TRAIN_ID


def encode_cityscapes_target(mask: np.ndarray) -> np.ndarray:
    return _CITYSCAPES_LUT[np.asarray(mask).astype(np.uint8)]


def decode_cityscapes_target(train_ids: np.ndarray) -> np.ndarray:
    t = train_ids.copy()
    t[t == 255] = 19
    return CITYSCAPES_TRAIN_ID_TO_COLOR[t]


class CityscapesCorruptDataset(_Base):
    """Per-sample choice among {randcorrupt, fog1, fog2, fog3} when the
    manifest row carries 3 foggy variants (dataset_seg.py:141-176)."""
    IMG_TYPES = ("randcorrupt", "fog1", "fog2", "fog3")

    def __getitem__(self, index: int, epoch: int = 0):
        rng = self.rng(index, epoch)
        rec = self.dataset[index]
        if len(rec) == 5:
            fogs, hq_p, label_p = rec[:3], rec[3], rec[4]
            img_type = self.IMG_TYPES[int(rng.integers(0, 4))]
        else:
            # 3-field rows: the manifest's lq path is intentionally unused
            # — the reference's 4-field branch also randcorrupts a copy of
            # the clean image (dataset_seg.py:146-161: img_type is always
            # "randcorrupt" there, so lq = hq.clone())
            _lq_p, hq_p, label_p = rec[0], rec[1], rec[2]
            fogs, img_type = None, "randcorrupt"
        import os
        fname = os.path.basename(hq_p)
        hq = load_image(hq_p)
        label = encode_cityscapes_target(load_mask(label_p))
        if img_type.startswith("fog"):
            lq = load_image(fogs[int(img_type[-1]) - 1])
        else:
            lq = hq.copy()

        if self.is_train:
            i, j, th, tw = _rand_crop_params(rng, *hq.shape[:2],
                                             self.resolution)
            hq = hq[i:i + th, j:j + tw]
            lq = lq[i:i + th, j:j + tw]
            label = label[i:i + th, j:j + tw]
            if rng.uniform() > 0.5:
                hq, lq, label = hq[:, ::-1], lq[:, ::-1], label[:, ::-1]

        if img_type == "randcorrupt":
            mode, severity = pick_corruption(rng, self.corruption_funcs)
            lq = degrade_image(rng, np.ascontiguousarray(lq), mode, severity,
                               self.resolution)
        return {"lq": _to_float(lq), "hq": _to_float(hq),
                "gt": np.ascontiguousarray(label).astype(np.int64),
                "fname": fname, "task": "seg"}


class CityscapesPairDataset(_Base):
    """Validation pairs; crp_mode in {fog1, fog2, fog3} selects the fog level
    on 5-field rows (dataset_seg.py:306-317)."""

    def __getitem__(self, index: int, epoch: int = 0):
        import os
        rec = self.dataset[index]
        if len(rec) == 5:
            fogs, hq_p, label_p = rec[:3], rec[3], rec[4]
            level = {"fog1": 0, "fog2": 1, "fog3": 2}.get(self.crp_mode, 0)
            lq_p = fogs[level]
        else:
            lq_p, hq_p, label_p = rec[0], rec[1], rec[2]
        hq = load_image(hq_p)
        lq = load_image(lq_p) if lq_p and lq_p != "None" else hq.copy()
        label = encode_cityscapes_target(load_mask(label_p))
        return {"lq": _to_float(lq), "hq": _to_float(hq),
                "gt": label.astype(np.int64),
                "fname": os.path.basename(hq_p), "task": "seg"}


class SEGRealDataset(_Base):
    """Real foggy/adverse data: lq + mask only (ACDC, Foggy Zurich)."""

    def __getitem__(self, index: int, epoch: int = 0):
        import os
        lq_p, hq_p, label_p, fname = parse_triplet(self.dataset[index])
        lq = load_image(lq_p)
        label = encode_cityscapes_target(load_mask(label_p)) \
            if label_p else None
        return {"lq": _to_float(lq), "hq": None,
                "gt": label.astype(np.int64) if label is not None else None,
                "fname": fname, "task": "seg"}
