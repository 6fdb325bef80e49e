"""Classification probe zoo: the ``cls`` engine's eval-mode classifier sets
(the port of ``unirestore_tpu/tasks/classifier_zoo.py``).

``EVAL_MODE_SETS`` maps an ``eval_mode`` to its probes
(eval_classification.py:36-48) and ``_SPECS`` a probe to its network, its
converted weights file and its class count:

  r50v1 / r50v2 / r101v1 / r18      resnet50_v1 / resnet50_v2 / resnet101_v1 / resnet18_v1
  vgg / vit / swin / rvt / eff       vgg16 / vit_b16 / swin_v2_b / rvt_base_plus
                                     / efficientnet_v2_l
  *_ft                               <base>_ft (fine-tuned exports)
  cub_r18/cub_r50/cub_conv/cub_vitb/cub_swin   cub200-tuned exports (200 classes)

Each probe is the seeded fp32 tree of its network with
``<weights_dir>/<weights>.npz`` merged in where present (else the seeded
init and a warning, ``zoo.load_npz_tree``), on ``device`` (default: the
card) in place of the JAX package's ``jit``; it takes numpy [0, 1] NHWC and
returns fp32 numpy logits (``evalx/evaluators.py:as_probe``).
"""

from __future__ import annotations

from .. import zoo
from ..device import resolve_device
from ..evalx.evaluators import as_probe
from ..nn.init import make_init
from . import convnext as CNX
from . import efficientnet as EFF
from . import resnet as RN
from . import rvt as RVT
from . import swin as SW
from . import vgg as VGG
from . import vit as VIT

EVAL_MODE_SETS = {
    "all": ["r50v1", "r101v1", "vgg", "swin", "vit", "rvt"],
    "all_ft": ["r50v1_ft", "r50v2_ft", "vgg_ft", "swin_ft", "vit_ft", "rvt"],
    "single": ["r50v1", "r50v2"],
    "bare": [],
    "CUB": ["cub_r18", "cub_r50", "cub_conv", "cub_vitb", "cub_swin"],
}

# model_type -> (init(ini, num_classes), apply(p, imgs), weights, n_class)
_SPECS = {
    "r18": (lambda i, n: RN.resnet_init(i, "resnet18", n), RN.resnet_apply, "resnet18_v1", 1000),
    "r50v1": (lambda i, n: RN.resnet_init(i, "resnet50", n), RN.resnet_apply, "resnet50_v1",
              1000),
    "r50v2": (lambda i, n: RN.resnet_init(i, "resnet50", n), RN.resnet_apply, "resnet50_v2",
              1000),
    "r101v1": (lambda i, n: RN.resnet_init(i, "resnet101", n), RN.resnet_apply,
               "resnet101_v1", 1000),
    "vgg": (VGG.vgg16_init, VGG.vgg16_apply, "vgg16", 1000),
    "vit": (VIT.vit_b16_init, VIT.vit_b16_apply, "vit_b16", 1000),
    "swin": (lambda i, n: SW.swin_base_init(i, n, v2=True),
             lambda p, x: SW.swin_base_apply(p, x, v2=True), "swin_v2_b", 1000),
    "rvt": (RVT.rvt_base_plus_init, RVT.rvt_base_plus_apply, "rvt_base_plus", 1000),
    "eff": (EFF.efficientnet_v2_l_init, EFF.efficientnet_v2_l_apply, "efficientnet_v2_l", 1000),
    "cub_r18": (lambda i, n: RN.resnet_init(i, "resnet18", 200), RN.resnet_apply,
                "cub_resnet18", 200),
    "cub_r50": (lambda i, n: RN.resnet_init(i, "resnet50", 200), RN.resnet_apply,
                "cub_resnet50", 200),
    "cub_conv": (lambda i, n: CNX.convnext_base_init(i, 200), CNX.convnext_base_apply,
                 "cub_convnext_base", 200),
    "cub_vitb": (lambda i, n: VIT.vit_b16_init(i, 200), VIT.vit_b16_apply, "cub_vit_b16", 200),
    "cub_swin": (lambda i, n: SW.swin_base_init(i, 200, v2=False),
                 lambda p, x: SW.swin_base_apply(p, x, v2=False), "cub_swin_base", 200),
}


def model_types_for(eval_mode: str) -> list[str]:
    if eval_mode not in EVAL_MODE_SETS:
        raise ValueError(f"Unknown eval_mode: {eval_mode}")
    return list(EVAL_MODE_SETS[eval_mode])


def _spec(model_type: str):
    """(init, apply, weights file, classes) of a probe; ``_ft`` selects ``<weights>_ft``."""
    base = model_type[:-3] if model_type.endswith("_ft") else model_type
    if base not in _SPECS:
        raise ValueError(f"Unknown classifier name: {model_type}")
    init, apply, weights, n_class = _SPECS[base]
    if model_type.endswith("_ft"):
        weights = f"{weights}_ft"
    return init, apply, weights, n_class


def classifier_init(model_type: str, seed: int = 7, device=None):
    """The seeded fp32 tree of a probe (``device="meta"``: shapes only)."""
    init, _, _, n_class = _spec(model_type)
    dev = "meta" if device == "meta" else resolve_device(device)
    return init(make_init(None, dev, seed=seed), n_class)


def classifier_apply(model_type: str, p, images):
    """A probe's logits (B, classes) on [0, 1] NHWC tensors."""
    return _spec(model_type)[1](p, images)


def build_classifier(model_type: str, seed: int = 7, device=None, weights_dir=None):
    """Returns ``fn(images_nhwc01) -> logits`` for one probe, on ``device``."""
    dev = resolve_device(device)
    _, apply, weights, _ = _spec(model_type)
    p, _ = zoo.load_npz_tree(weights, classifier_init(model_type, seed, dev), weights_dir)
    return as_probe(lambda x: apply(p, x), dev)


def build_classifier_zoo(eval_mode: str = "single", seed: int = 7, device=None,
                         weights_dir=None) -> dict:
    """name -> fn for the eval_mode's probe set."""
    return {mt: build_classifier(mt, seed, device, weights_dir)
            for mt in model_types_for(eval_mode)}
