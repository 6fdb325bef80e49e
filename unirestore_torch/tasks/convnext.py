"""ConvNeXt-Base classifier probe, NHWC (the port of ``unirestore_tpu/tasks/convnext.py``).

timm ``convnext_base``, the CUB set's ``cub_conv`` probe (200 classes).
Stages [3, 3, 27, 3] at dims [128, 256, 512, 1024]; a block is a depthwise
7x7 convolution (padding 3), LayerNorm (eps 1e-6), a pointwise x4 expansion,
exact GELU, the pointwise projection, the layer scale ``gamma`` and the
residual; between stages LayerNorm then a 2x2/2 ``VALID`` convolution; the
head is the spatial mean, LayerNorm and a linear layer. The tree has the JAX
tree's keys and shapes (conv kernels OIHW, linear ``w`` (in, out)).
"""

from __future__ import annotations

from ..nn import layers as L
from . import resnet as RN

DEPTHS = (3, 3, 27, 3)
DIMS = (128, 256, 512, 1024)


def _block_init(ini, dim):
    return {"dwconv": L.conv2d_init(ini, dim, dim, 7, groups=dim),
            "norm": L.norm_init(ini, dim),
            "fc1": L.linear_init(ini, dim, dim * 4),
            "fc2": L.linear_init(ini, dim * 4, dim),
            "gamma": ini.full((dim,), 1e-6)}


def convnext_base_init(ini, num_classes: int = 1000):
    """The parameter tree (``ini``: an ``nn.init.Init``)."""
    p = {"stem": L.conv2d_init(ini, 3, DIMS[0], 4),
         "stem_norm": L.norm_init(ini, DIMS[0]),
         "stages": [], "downsample": [],
         "norm": L.norm_init(ini, DIMS[-1]),
         "head": L.linear_init(ini, DIMS[-1], num_classes)}
    for i, (depth, dim) in enumerate(zip(DEPTHS, DIMS)):
        if i > 0:
            p["downsample"].append({"norm": L.norm_init(ini, DIMS[i - 1]),
                                    "conv": L.conv2d_init(ini, DIMS[i - 1], dim, 2)})
        p["stages"].append([_block_init(ini, dim) for _ in range(depth)])
    return p


def _block(p, x):
    h = L.conv2d(p["dwconv"], x, padding=3, groups=x.shape[-1])
    h = L.layer_norm(p["norm"], h, eps=1e-6)
    h = L.gelu(L.linear(p["fc1"], h))
    h = L.linear(p["fc2"], h)
    return x + h * p["gamma"].to(h.dtype)


def convnext_base_apply(p, images, preprocess_input: bool = True):
    """[0, 1] NHWC -> logits; resizes to 224 px inside."""
    x = RN.preprocess(images) if preprocess_input else images
    h = L.conv2d(p["stem"], x, stride=4, padding="VALID")
    h = L.layer_norm(p["stem_norm"], h, eps=1e-6)
    for i, stage in enumerate(p["stages"]):
        if i > 0:
            ds = p["downsample"][i - 1]
            h = L.layer_norm(ds["norm"], h, eps=1e-6)
            h = L.conv2d(ds["conv"], h, stride=2, padding="VALID")
        for blk in stage:
            h = _block(blk, h)
    pooled = L.layer_norm(p["norm"], h.mean(dim=(1, 2)), eps=1e-6)
    return L.linear(p["head"], pooled)
