"""Frozen downstream networks: the critics of stages 2 and 3 and the
validation probes (mirrors ``unirestore_tpu/tasks``: ``resnet``, ``deeplab``,
``retinanet`` and ``fasterrcnn``; and the probe zoos of the ``cls`` and
``seg`` engines, ``classifier_zoo`` over ``vgg``, ``vit``, ``rvt``, ``swin``,
``convnext`` and ``efficientnet``, and ``seg_zoo`` over ``refinenet``; all
ported. ``backbones``, the non-ResNet DeepLab backbones, is not).

``critic_init(task, device, downstream)`` builds the critic of a task with the
seeded init the JAX engine's ``build_critics`` uses in place of missing
weights (ResNet-50 for ``cls``, DeepLabV3+-ResNet-50 for ``seg``, and for
``det`` the detector ``downstream`` names: Faster R-CNN for ``fastrcnn``,
RetinaNet otherwise, as in the JAX engine); ``CRITIC_WEIGHTS`` names the
converted file each loads from (``zoo.load_npz_tree``, by ``critic_name``),
and ``critic_apply(task, p, images)`` runs a ``cls`` or ``seg`` critic on
[0, 1] NHWC images (the detectors' losses and detections are in their
modules).
"""

from __future__ import annotations

from ..device import resolve_device
from ..nn.init import make_init
from . import deeplab as DL
from . import fasterrcnn as FRC
from . import resnet as RN
from . import retinanet as RET

CRITIC_WEIGHTS = {"cls": "resnet50_v1", "seg": "deeplabv3plus_resnet50",
                  "retinanet": "retinanet_resnet50", "fastrcnn": "fasterrcnn_resnet50"}
CRITIC_SEEDS = {"cls": 7, "seg": 8, "det": 9}
_INITS = {"cls": lambda ini: RN.resnet_init(ini, "resnet50"), "seg": DL.deeplabv3plus_init,
          "retinanet": RET.retinanet_init, "fastrcnn": FRC.fasterrcnn_init}


def critic_name(task: str, downstream: str | None = None) -> str:
    """The network a task's critic is: the task itself, or for ``det`` the detector."""
    if task == "det":
        return "fastrcnn" if downstream == "fastrcnn" else "retinanet"
    return task


def critic_init(task: str, device=None, downstream: str | None = None):
    """The seeded parameter tree of ``task``'s critic (fp32; ``device="meta"``: shapes only)."""
    name = critic_name(task, downstream)
    if name not in _INITS:
        raise KeyError(f"no critic for task {task!r}")
    dev = "meta" if device == "meta" else resolve_device(device)
    return _INITS[name](make_init(None, dev, seed=CRITIC_SEEDS[task]))


def critic_apply(task: str, p, images):
    """Logits of ``task``'s critic on [0, 1] NHWC ``images``: (B, 1000) for
    ``cls``, (B, H, W, 19) at the input size for ``seg``."""
    if task == "cls":
        return RN.resnet_apply(p, images)
    if task == "seg":
        return DL.deeplabv3plus_apply(p, images)
    raise KeyError(f"no critic for task {task!r}")
