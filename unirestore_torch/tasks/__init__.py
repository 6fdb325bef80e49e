"""Frozen downstream networks: the stage-2 critics and validation probes
(mirrors ``unirestore_tpu/tasks``: ``resnet`` and ``deeplab`` so far).

``critic_init(task)`` builds the critic of a task with the seeded init the
JAX engine's ``build_critics`` uses in place of missing weights (ResNet-50
for ``cls``, DeepLabV3+-ResNet-50 for ``seg``); ``CRITIC_WEIGHTS`` names the
converted file each loads from (``zoo.load_npz_tree``), and
``critic_apply(task, p, images)`` runs it on [0, 1] NHWC images.
"""

from __future__ import annotations

from ..device import resolve_device
from ..nn.init import make_init
from . import deeplab as DL
from . import resnet as RN

CRITIC_WEIGHTS = {"cls": "resnet50_v1", "seg": "deeplabv3plus_resnet50"}
CRITIC_SEEDS = {"cls": 7, "seg": 8}


def critic_init(task: str, device=None):
    """The seeded parameter tree of ``task``'s critic (fp32; ``device="meta"``: shapes only)."""
    dev = "meta" if device == "meta" else resolve_device(device)
    ini = make_init(None, dev, seed=CRITIC_SEEDS[task])
    if task == "cls":
        return RN.resnet_init(ini, "resnet50")
    if task == "seg":
        return DL.deeplabv3plus_init(ini)
    raise KeyError(f"no critic for task {task!r}")


def critic_apply(task: str, p, images):
    """Logits of ``task``'s critic on [0, 1] NHWC ``images``: (B, 1000) for
    ``cls``, (B, H, W, 19) at the input size for ``seg``."""
    if task == "cls":
        return RN.resnet_apply(p, images)
    if task == "seg":
        return DL.deeplabv3plus_apply(p, images)
    raise KeyError(f"no critic for task {task!r}")
