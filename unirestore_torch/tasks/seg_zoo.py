"""Segmentation probe zoo: the ``seg`` engine's eval-mode sets (the port of
``unirestore_tpu/tasks/seg_zoo.py``).

eval_semantic_segmentation.py:37-50: ``single`` = [dlv3pr50, rflwr101];
``all`` = [dlv3pr50, dlv3pr50_ft, rflwr101, rflwr101_ft, rflwr101_fifo];
``bare`` = []. DeepLabV3+-ResNet-50 at output stride 16 and
RefineNet-LW-101, each with its own converted weights (``_WEIGHTS``; the
seeded init and a warning where a file is absent). The monitor is
``val_lq/rflwr101``. Each probe takes numpy [0, 1] NHWC and returns fp32
numpy logits (B, H, W, 19), on ``device`` (default: the card).
"""

from __future__ import annotations

from .. import zoo
from ..device import resolve_device
from ..evalx.evaluators import as_probe
from ..nn.init import make_init
from . import deeplab as DL
from . import refinenet as RFN

EVAL_MODE_SETS = {
    "single": ["dlv3pr50", "rflwr101"],
    "all": ["dlv3pr50", "dlv3pr50_ft", "rflwr101", "rflwr101_ft", "rflwr101_fifo"],
    "bare": [],
}

_WEIGHTS = {
    "dlv3pr50": "deeplabv3plus_resnet50",
    "dlv3pr50_ft": "deeplabv3plus_resnet50_ft",
    "rflwr101": "refinenet_lw101",
    "rflwr101_ft": "refinenet_lw101_ft",
    "rflwr101_fifo": "refinenet_lw101_fifo",
}


def model_types_for(eval_mode: str) -> list[str]:
    if eval_mode not in EVAL_MODE_SETS:
        raise ValueError(f"Unknown eval_mode: {eval_mode}")
    return list(EVAL_MODE_SETS[eval_mode])


def _network(model_type: str):
    """(init(ini), apply(p, imgs)) of a probe."""
    if model_type not in _WEIGHTS:
        raise ValueError(f"Unknown model type: {model_type}")
    if model_type.startswith("dlv3pr50"):
        return DL.deeplabv3plus_init, DL.deeplabv3plus_apply
    return RFN.refinenet_lw_init, RFN.refinenet_lw_apply


def seg_probe_init(model_type: str, seed: int = 8, device=None):
    """The seeded fp32 tree of a probe (``device="meta"``: shapes only)."""
    init, _ = _network(model_type)
    dev = "meta" if device == "meta" else resolve_device(device)
    return init(make_init(None, dev, seed=seed))


def seg_probe_apply(model_type: str, p, images):
    """A probe's logits (B, H, W, 19) at the input size on [0, 1] NHWC tensors."""
    return _network(model_type)[1](p, images)


def build_seg_probe(model_type: str, seed: int = 8, device=None, weights_dir=None):
    """Returns ``fn(images_nhwc01) -> logits (B, H, W, 19)``, on ``device``."""
    dev = resolve_device(device)
    _, apply = _network(model_type)
    p, _ = zoo.load_npz_tree(_WEIGHTS[model_type], seg_probe_init(model_type, seed, dev),
                             weights_dir)
    return as_probe(lambda x: apply(p, x), dev)


def build_seg_zoo(eval_mode: str = "single", seed: int = 8, device=None,
                  weights_dir=None) -> dict:
    return {mt: build_seg_probe(mt, seed, device, weights_dir)
            for mt in model_types_for(eval_mode)}
