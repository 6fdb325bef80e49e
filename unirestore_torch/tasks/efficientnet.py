"""EfficientNetV2-L classifier probe, NHWC (the port of ``unirestore_tpu/tasks/efficientnet.py``).

torchvision ``efficientnet_v2_l``: a 3x3/2 stem, three FusedMBConv stages,
four MBConv stages with squeeze-and-excitation (squeeze width a quarter of
the block's input channels, on the spatial mean), a 1x1 head to 1280
channels, the spatial mean and a linear layer; inference BatchNorm with eps
``BN_EPS``, SiLU. Convolutions pad ``"SAME"`` at stride 1 and ``(k - 1) //
2`` when strided; the depthwise ones have one group per channel. ``eff`` is
in the zoo's specs but in no eval-mode set. The tree has the JAX tree's keys
and shapes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..nn import layers as L
from . import resnet as RN

# (fused, expand, kernel, stride, cin, cout, layers)
V2L_PLAN = (
    (True, 1, 3, 1, 32, 32, 4),
    (True, 4, 3, 2, 32, 64, 7),
    (True, 4, 3, 2, 64, 96, 7),
    (False, 4, 3, 2, 96, 192, 10),
    (False, 6, 3, 1, 192, 224, 19),
    (False, 6, 3, 2, 224, 384, 25),
    (False, 6, 3, 1, 384, 640, 7),
)
BN_EPS = 1e-3


def _cbn_init(ini, cin, cout, k, groups: int = 1):
    return {"conv": L.conv2d_init(ini, cin, cout, k, groups=groups, bias=False),
            "bn": RN.bn_init(ini, cout)}


def _block_init(ini, fused, expand, k, cin, cout):
    mid = cin * expand
    if fused:
        if expand != 1:
            return {"expand": _cbn_init(ini, cin, mid, k), "project": _cbn_init(ini, mid, cout, 1)}
        return {"single": _cbn_init(ini, cin, cout, k)}
    se_c = max(1, cin // 4)
    return {"expand": _cbn_init(ini, cin, mid, 1),
            "dw": _cbn_init(ini, mid, mid, k, groups=mid),
            "se_reduce": L.conv2d_init(ini, mid, se_c, 1),
            "se_expand": L.conv2d_init(ini, se_c, mid, 1),
            "project": _cbn_init(ini, mid, cout, 1)}


def efficientnet_v2_l_init(ini, num_classes: int = 1000):
    """The parameter tree (``ini``: an ``nn.init.Init``)."""
    p = {"stem": _cbn_init(ini, 3, 32, 3), "stages": []}
    for fused, expand, k, _stride, cin, cout, layers in V2L_PLAN:
        p["stages"].append([_block_init(ini, fused, expand, k, cin if j == 0 else cout, cout)
                            for j in range(layers)])
    p["head"] = _cbn_init(ini, 640, 1280, 1)
    p["fc"] = L.linear_init(ini, 1280, num_classes)
    return p


def _cbn(p, x, stride=1, k=1, groups=1):
    pad = "SAME" if stride == 1 else (k - 1) // 2
    h = L.conv2d(p["conv"], x, stride=stride, padding=pad, groups=groups)
    return RN.batch_norm(p["bn"], h, eps=BN_EPS)


def _block(p, x, fused, k, stride):
    if fused:
        if "single" in p:
            h = F.silu(_cbn(p["single"], x, stride, k))
        else:
            h = F.silu(_cbn(p["expand"], x, stride, k))
            h = _cbn(p["project"], h)
    else:
        h = F.silu(_cbn(p["expand"], x))
        h = F.silu(_cbn(p["dw"], h, stride, k, groups=h.shape[-1]))
        s = h.mean(dim=(1, 2), keepdim=True)
        s = F.silu(L.conv2d(p["se_reduce"], s))
        s = torch.sigmoid(L.conv2d(p["se_expand"], s))
        h = _cbn(p["project"], h * s)
    if stride == 1 and x.shape[-1] == h.shape[-1]:
        h = h + x
    return h


def efficientnet_v2_l_apply(p, images, preprocess_input: bool = True):
    """[0, 1] NHWC -> logits; resizes to 224 px inside."""
    x = RN.preprocess(images) if preprocess_input else images
    h = F.silu(_cbn(p["stem"], x, stride=2, k=3))
    for (fused, _expand, k, stride, *_), stage in zip(V2L_PLAN, p["stages"]):
        for j, blk in enumerate(stage):
            h = _block(blk, h, fused, k, stride if j == 0 else 1)
    h = F.silu(_cbn(p["head"], h))
    return L.linear(p["fc"], h.mean(dim=(1, 2)))
