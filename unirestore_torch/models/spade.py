"""SPADE, spatially-adaptive GroupNorm modulation (mirrors ``unirestore_tpu/models/spade.py:18-34``).

The ``spade`` control type of the UNet: GroupNorm(32, eps 1e-5) on x with the
affine ``norm`` params, the control map nearest-resized to x's H x W
(``nn/layers.py:resize_nearest``), a shared 3x3 conv + ReLU, then 3x3 gamma
and beta heads: ``norm(x) * (1 + gamma) + beta``. NHWC maps.
"""

from __future__ import annotations

import torch.nn.functional as F

from ..nn import layers as L

NHIDDEN = 128


def spade_init(ini, norm_nc: int, label_nc: int = 128):
    return {
        "norm": L.norm_init(ini, norm_nc),
        "mlp_shared": L.conv2d_init(ini, label_nc, NHIDDEN, 3),
        "mlp_gamma": L.conv2d_init(ini, NHIDDEN, norm_nc, 3),
        "mlp_beta": L.conv2d_init(ini, NHIDDEN, norm_nc, 3),
    }


def spade(p, x, segmap):
    normalized = L.group_norm(p["norm"], x, groups=32, eps=1e-5)
    seg = L.resize_nearest(segmap, (x.shape[1], x.shape[2]))
    actv = F.relu(L.conv2d(p["mlp_shared"], seg, padding=1))
    gamma = L.conv2d(p["mlp_gamma"], actv, padding=1)
    beta = L.conv2d(p["mlp_beta"], actv, padding=1)
    return normalized * (1.0 + gamma) + beta
