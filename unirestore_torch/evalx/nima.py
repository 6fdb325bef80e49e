"""NIMA no-reference metric over Inception-ResNet-V2 (the port of
``unirestore_tpu/evalx/nima.py``; reference: eval_image_restoration.py:197
``PyNRMetric('nima-koniq')``).

NIMA (Talebi & Milanfar, TIP 2018): pooled features -> linear head. The AVA
variant gives a 10-bin distribution whose expectation (1..10) is the score;
the KonIQ-10k variant regresses one MOS. The tree has the JAX tree's keys and
shapes (conv kernels OIHW). Inputs are NHWC in [0, 1], resized to 224 px and
ImageNet-normalised. BatchNorm eps is 1e-3; ``"SAME"`` convolutions occur
only at stride 1 and the stride-2 ones are ``"VALID"``; the 3 x 3 average
pool divides by the count of valid elements.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..nn import layers as L
from ..tasks import resnet as RN

BN_EPS = 1e-3


def _cbn_init(ini, cin, cout, k):
    return {"conv": L.conv2d_init(ini, cin, cout, k, bias=False), "bn": RN.bn_init(ini, cout)}


def _cbn(p, x, stride=1, padding="SAME"):
    h = L.conv2d(p["conv"], x, stride=stride, padding=padding)
    return F.relu(RN.batch_norm(p["bn"], h, eps=BN_EPS))


def _branch_init(ini, specs):
    """specs: (cin, cout, k) of each conv + BN stage."""
    return [_cbn_init(ini, cin, cout, k) for cin, cout, k in specs]


def _block35_init(ini):
    return {"b0": _branch_init(ini, [(320, 32, 1)]),
            "b1": _branch_init(ini, [(320, 32, 1), (32, 32, 3)]),
            "b2": _branch_init(ini, [(320, 32, 1), (32, 48, 3), (48, 64, 3)]),
            "conv": L.conv2d_init(ini, 128, 320, 1)}


def _block17_init(ini):
    return {"b0": _branch_init(ini, [(1088, 192, 1)]),
            "b1": _branch_init(ini, [(1088, 128, 1), (128, 160, (1, 7)), (160, 192, (7, 1))]),
            "conv": L.conv2d_init(ini, 384, 1088, 1)}


def _block8_init(ini):
    return {"b0": _branch_init(ini, [(2080, 192, 1)]),
            "b1": _branch_init(ini, [(2080, 192, 1), (192, 224, (1, 3)), (224, 256, (3, 1))]),
            "conv": L.conv2d_init(ini, 448, 2080, 1)}


def inception_resnet_v2_init(ini, num_classes: int = 10):
    """The parameter tree (``ini``: an ``nn.init.Init``)."""
    return {
        "stem": [_cbn_init(ini, 3, 32, 3),    # conv2d_1a /2 VALID
                 _cbn_init(ini, 32, 32, 3),   # conv2d_2a VALID
                 _cbn_init(ini, 32, 64, 3),   # conv2d_2b SAME
                 _cbn_init(ini, 64, 80, 1),   # conv2d_3b
                 _cbn_init(ini, 80, 192, 3)],  # conv2d_4a VALID
        "mixed_5b": {"b0": _branch_init(ini, [(192, 96, 1)]),
                     "b1": _branch_init(ini, [(192, 48, 1), (48, 64, 5)]),
                     "b2": _branch_init(ini, [(192, 64, 1), (64, 96, 3), (96, 96, 3)]),
                     "bp": _branch_init(ini, [(192, 64, 1)])},
        "repeat": [_block35_init(ini) for _ in range(10)],
        "mixed_6a": {"b0": _branch_init(ini, [(320, 384, 3)]),
                     "b1": _branch_init(ini, [(320, 256, 1), (256, 256, 3), (256, 384, 3)])},
        "repeat_1": [_block17_init(ini) for _ in range(20)],
        "mixed_7a": {"b0": _branch_init(ini, [(1088, 256, 1), (256, 384, 3)]),
                     "b1": _branch_init(ini, [(1088, 256, 1), (256, 288, 3)]),
                     "b2": _branch_init(ini, [(1088, 256, 1), (256, 288, 3), (288, 320, 3)])},
        "repeat_2": [_block8_init(ini) for _ in range(9)],
        "block8": _block8_init(ini),
        "conv2d_7b": _cbn_init(ini, 2080, 1536, 1),
        "head": L.linear_init(ini, 1536, num_classes),
    }


def _branch(blocks, x, pads=None, strides=None):
    for i, blk in enumerate(blocks):
        x = _cbn(blk, x, stride=strides[i] if strides else 1,
                 padding=pads[i] if pads else "SAME")
    return x


def _residual_block(p, x, scale, branches, activate=True):
    mix = torch.cat([_branch(p[name], x) for name in branches], dim=-1)
    x = x + scale * L.conv2d(p["conv"], mix)
    return F.relu(x) if activate else x


def _maxpool3_s2(x):
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)


def _avgpool3_s1(x):
    """3 x 3 average, stride 1, padded by one, over the valid elements only."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), 3, 1, 1, count_include_pad=False)
    return y.permute(0, 2, 3, 1)


def inception_resnet_v2_features(p, x):
    """Normalised NHWC -> (B, 1536) pooled features."""
    st = p["stem"]
    h = _cbn(st[0], x, stride=2, padding="VALID")
    h = _cbn(st[1], h, padding="VALID")
    h = _cbn(st[2], h)
    h = _maxpool3_s2(h)
    h = _cbn(st[3], h)
    h = _cbn(st[4], h, padding="VALID")
    h = _maxpool3_s2(h)
    m = p["mixed_5b"]
    h = torch.cat([_branch(m["b0"], h), _branch(m["b1"], h), _branch(m["b2"], h),
                   _branch(m["bp"], _avgpool3_s1(h))], dim=-1)  # 320
    for blk in p["repeat"]:
        h = _residual_block(blk, h, 0.17, ("b0", "b1", "b2"))
    m = p["mixed_6a"]
    h = torch.cat([_branch(m["b0"], h, pads=["VALID"], strides=[2]),
                   _branch(m["b1"], h, pads=["SAME", "SAME", "VALID"], strides=[1, 1, 2]),
                   _maxpool3_s2(h)], dim=-1)  # 1088
    for blk in p["repeat_1"]:
        h = _residual_block(blk, h, 0.10, ("b0", "b1"))
    m = p["mixed_7a"]
    h = torch.cat([_branch(m["b0"], h, pads=["SAME", "VALID"], strides=[1, 2]),
                   _branch(m["b1"], h, pads=["SAME", "VALID"], strides=[1, 2]),
                   _branch(m["b2"], h, pads=["SAME", "SAME", "VALID"], strides=[1, 1, 2]),
                   _maxpool3_s2(h)], dim=-1)  # 2080
    for blk in p["repeat_2"]:
        h = _residual_block(blk, h, 0.20, ("b0", "b1"))
    h = _residual_block(p["block8"], h, 1.0, ("b0", "b1"), activate=False)
    h = _cbn(p["conv2d_7b"], h)
    return h.mean(dim=(1, 2))


def nima_features(p, images, preprocess_input: bool = True):
    x = RN.preprocess(images) if preprocess_input else images
    return inception_resnet_v2_features(p, x)


def nima_head(p, feats, num_classes: int = 10):
    """Pooled features -> score: the expectation over 10 bins, or the one
    regressed value at ``num_classes=1``."""
    out = L.linear(p["head"], feats).float()
    if num_classes == 1:
        return out[:, 0]
    probs = torch.softmax(out, dim=-1)
    bins = torch.arange(1, num_classes + 1, dtype=torch.float32, device=out.device)
    return (probs * bins).sum(dim=-1)


def nima_score(p, images, num_classes: int = 10, preprocess_input: bool = True):
    """[0, 1] NHWC -> NIMA score per image."""
    return nima_head(p, nima_features(p, images, preprocess_input), num_classes)
