"""RVT (Robust Vision Transformer) classifier probe ``rvt_base_plus``, NHWC
(the port of ``unirestore_tpu/tasks/rvt.py``).

The ``all`` and ``all_ft`` sets' ``rvt``. A convolutional stem (7x7/2 with
padding 2, BatchNorm, a 3x3/2 max pool padded by one, a 4x4/4 convolution)
makes 196 tokens of 768 channels from the 224 px image; one stage of 12
pre-norm blocks with 12 heads and qkv bias, whose first ``MASKED_BLOCKS``
carry a learned ``att_mask`` (heads, 196, 196): ``sigmoid(att_mask)``
multiplies the scaled logits before the softmax, in those blocks only; then
the token mean, LayerNorm (eps 1e-6) and a linear head. The tree has the
JAX tree's keys and shapes.
"""

from __future__ import annotations

import torch

from ..nn import layers as L
from . import resnet as RN
from . import vit as VIT

EMBED = 768
HEADS = 12
DEPTH = 12
MASKED_BLOCKS = 5
TOKENS = 196  # 224 input -> 14x14


def _block_init(ini, dim, mlp_ratio: int = 4, use_mask: bool = False):
    p = VIT._block_init(ini, dim, dim * mlp_ratio)
    if use_mask:
        p["att_mask"] = ini.normal((HEADS, TOKENS, TOKENS), 0.02)
    return p


def rvt_base_plus_init(ini, num_classes: int = 1000):
    """The parameter tree (``ini``: an ``nn.init.Init``)."""
    return {"stem_conv1": L.conv2d_init(ini, 3, 32, 7),
            "stem_bn": RN.bn_init(ini, 32),
            "stem_conv2": L.conv2d_init(ini, 32, EMBED, 4),
            "blocks": [_block_init(ini, EMBED, use_mask=i < MASKED_BLOCKS)
                       for i in range(DEPTH)],
            "norm": L.norm_init(ini, EMBED),
            "head": L.linear_init(ini, EMBED, num_classes)}


def _attention(p, x):
    gate = torch.sigmoid(p["att_mask"].to(x.dtype)) if "att_mask" in p else None
    return VIT._attention(p, x, HEADS, gate)


def rvt_base_plus_apply(p, images, preprocess_input: bool = True):
    """[0, 1] NHWC -> logits; resizes to 224 px inside."""
    x = RN.preprocess(images) if preprocess_input else images
    h = L.conv2d(p["stem_conv1"], x, stride=2, padding=2)
    h = RN.batch_norm(p["stem_bn"], h)
    h = RN.max_pool_3x3_s2(h)
    h = L.conv2d(p["stem_conv2"], h, stride=4, padding="VALID")
    b, hh, ww, c = h.shape
    t = h.reshape(b, hh * ww, c)
    for blk in p["blocks"]:
        t = t + _attention(blk, L.layer_norm(blk["norm1"], t, eps=1e-6))
        m = L.layer_norm(blk["norm2"], t, eps=1e-6)
        t = t + L.linear(blk["fc2"], L.gelu(L.linear(blk["fc1"], m)))
    pooled = L.layer_norm(p["norm"], t.mean(dim=1), eps=1e-6)
    return L.linear(p["head"], pooled)
