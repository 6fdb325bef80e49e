"""Light-Weight RefineNet-101, the frozen segmentation probe ``rflwr101``
(the port of ``unirestore_tpu/tasks/refinenet.py``).

The monitor of the ``seg`` engine (``val_lq/rflwr101``). On
``resnet.resnet_features`` of a ResNet-101 (no ``fc``): per-level 1x1
dimension reductions, 1x1 adapt convolutions on the skips, ReLU after the
sum, chained residual pooling (CRP: four rounds of a 5x5/1 max pool padded
with -inf and a 1x1 convolution, accumulated), per-level 1x1 fuse
convolutions, top-down upsampling with aligned corners, a 3x3 classifier at
/4 and, by default, the logits resized to the input with plain bilinear
(``resize_bilinear``). Inputs are NHWC in [0, 1], ImageNet-normalised at
their own size. The tree has the JAX tree's keys and shapes.
"""

from __future__ import annotations

import torch.nn.functional as F

from ..nn import layers as L
from ..ops.resize import resize_bilinear, resize_bilinear_ac
from . import resnet as RN

CRP_STAGES = 4


def _crp_init(ini, c: int):
    return [L.conv2d_init(ini, c, c, 1, bias=False) for _ in range(CRP_STAGES)]


def _crp(p, x):
    top = x
    for conv in p:
        top = F.max_pool2d(top.permute(0, 3, 1, 2), 5, 1, padding=2).permute(0, 2, 3, 1)
        top = L.conv2d(conv, top, padding=0)
        x = x + top
    return x


def refinenet_lw_init(ini, num_classes: int = 19, backbone: str = "resnet101"):
    """The parameter tree (``ini``: an ``nn.init.Init``)."""
    p = {"backbone": RN.resnet_init(ini, backbone)}
    del p["backbone"]["fc"]  # ResNetLW has no classification head
    chans = {"c5": 2048, "c4": 1024, "c3": 512, "c2": 256}
    p["dimred"] = {lvl: L.conv2d_init(ini, chans[lvl], 512 if lvl == "c5" else 256, 1,
                                      bias=False) for lvl in ("c5", "c4", "c3", "c2")}
    p["adapt"] = {lvl: L.conv2d_init(ini, 256, 256, 1, bias=False) for lvl in ("c4", "c3", "c2")}
    p["crp"] = {lvl: _crp_init(ini, 512 if lvl == "c5" else 256)
                for lvl in ("c5", "c4", "c3", "c2")}
    p["fuse"] = {lvl: L.conv2d_init(ini, 512 if lvl == "c5" else 256, 256, 1, bias=False)
                 for lvl in ("c5", "c4", "c3")}
    p["clf"] = L.conv2d_init(ini, 256, num_classes, 3)
    return p


def refinenet_lw_apply(p, images, preprocess_input: bool = True,
                       upsample_to_input: bool = True):
    """[0, 1] NHWC -> seg logits (B, H, W, classes) at the input size by
    default, else at /4."""
    h_in, w_in = images.shape[1:3]
    x = RN.normalize(images) if preprocess_input else images
    f = RN.resnet_features(p["backbone"], x)

    y = F.relu(L.conv2d(p["dimred"]["c5"], f["c5"], padding=0))
    y = _crp(p["crp"]["c5"], y)
    y = L.conv2d(p["fuse"]["c5"], y, padding=0)
    for lvl in ("c4", "c3", "c2"):
        skip = L.conv2d(p["dimred"][lvl], f[lvl], padding=0)
        skip = L.conv2d(p["adapt"][lvl], skip, padding=0)
        y = resize_bilinear_ac(y, (skip.shape[1], skip.shape[2]))
        y = F.relu(skip + y)
        y = _crp(p["crp"][lvl], y)
        if lvl != "c2":
            y = L.conv2d(p["fuse"][lvl], y, padding=0)

    logits = L.conv2d(p["clf"], y, padding=1)
    if upsample_to_input:
        logits = resize_bilinear(logits, (h_in, w_in))
    return logits
