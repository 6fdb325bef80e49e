"""ResNet classifier family over parameter trees (the port of ``unirestore_tpu/tasks/resnet.py``).

The frozen classification critic of stage 2 and the ``r50v1`` validation
probe: ResNet-v1 with inference BatchNorm (running statistics folded into a
per-channel scale and shift), NHWC at every public function. The tree has
the JAX tree's keys and shapes (``stem``; ``layers``, a list of stages, each
a list of blocks with ``conv1``-``conv3`` and ``downsample``, each a
``{"conv": {"w"}, "bn": {"scale", "bias", "mean", "var"}}``; ``fc`` a linear
layer with ``w`` of shape (in, out)), conv kernels OIHW, so the converted
``weights/resnet50_v1.npz`` and ``bridge.critics_from_jax`` read the same
files. Inputs are NHWC in [0, 1]; ``preprocess`` resizes to 224 px
(bilinear, no antialias) and normalises with the ImageNet statistics.

Convolutions pass ``"SAME"`` only at stride 1 and explicit integer padding
elsewhere, as ``nn/layers.py:conv2d`` accepts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..nn import layers as L
from ..ops.resize import resize_bilinear

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

BLOCKS = {"resnet18": (2, 2, 2, 2), "resnet50": (3, 4, 6, 3),
          "resnet101": (3, 4, 23, 3)}
BOTTLENECK = {"resnet18": False, "resnet50": True, "resnet101": True}


_STATS: dict = {}


def normalize(images):
    """[0, 1] NHWC -> ImageNet-normalised, in the input's dtype (the statistics
    are copied to the device once per dtype and device, as normal tensors even
    under ``inference_mode``, so that a training step may save them)."""
    key = (images.dtype, str(images.device))
    if key not in _STATS:
        with torch.inference_mode(False):
            _STATS[key] = tuple(torch.tensor(v, dtype=images.dtype, device=images.device)
                                for v in (IMAGENET_MEAN, IMAGENET_STD))
    mean, std = _STATS[key]
    return (images - mean) / std


def preprocess(images, size: int = 224):
    """[0, 1] NHWC -> ImageNet-normalised, resized to size x size."""
    return normalize(resize_bilinear(images, (size, size)))


def bn_init(ini, c):
    return {"scale": ini.ones((c,)), "bias": ini.zeros((c,)),
            "mean": ini.zeros((c,)), "var": ini.ones((c,))}


def batch_norm(p, x, eps: float = 1e-5):
    """Inference BN with running statistics; scale and shift in fp32, applied in x's dtype."""
    inv = torch.rsqrt(p["var"].float() + eps)
    scale = p["scale"].float() * inv
    shift = p["bias"].float() - p["mean"].float() * p["scale"].float() * inv
    return x * scale.to(x.dtype) + shift.to(x.dtype)


def _conv_bn_init(ini, cin, cout, k):
    return {"conv": L.conv2d_init(ini, cin, cout, k, bias=False), "bn": bn_init(ini, cout)}


def _bottleneck_init(ini, cin, width, cout, stride):
    p = {"conv1": _conv_bn_init(ini, cin, width, 1),
         "conv2": _conv_bn_init(ini, width, width, 3),
         "conv3": _conv_bn_init(ini, width, cout, 1)}
    if stride != 1 or cin != cout:
        p["downsample"] = _conv_bn_init(ini, cin, cout, 1)
    return p


def _basic_init(ini, cin, cout, stride):
    p = {"conv1": _conv_bn_init(ini, cin, cout, 3),
         "conv2": _conv_bn_init(ini, cout, cout, 3)}
    if stride != 1 or cin != cout:
        p["downsample"] = _conv_bn_init(ini, cin, cout, 1)
    return p


def resnet_init(ini, arch: str = "resnet50", num_classes: int = 1000):
    """The parameter tree of ``arch`` (``ini``: an ``nn.init.Init``)."""
    blocks, bottleneck = BLOCKS[arch], BOTTLENECK[arch]
    p = {"stem": _conv_bn_init(ini, 3, 64, 7)}
    cin, layers = 64, []
    for i, n in enumerate(blocks):
        width = 64 * 2 ** i
        cout = width * 4 if bottleneck else width
        stage = []
        for j in range(n):
            stride = 2 if (i > 0 and j == 0) else 1
            stage.append(_bottleneck_init(ini, cin, width, cout, stride) if bottleneck
                         else _basic_init(ini, cin, cout, stride))
            cin = cout
        layers.append(stage)
    p["layers"] = layers
    p["fc"] = L.linear_init(ini, cin, num_classes)
    return p


def _conv_bn(p, x, stride=1, padding="SAME", dilation=1):
    return batch_norm(p["bn"], L.conv2d(p["conv"], x, stride=stride, padding=padding,
                                        dilation=dilation))


def _bottleneck(p, x, stride, dilation=1):
    identity = x
    if "conv3" not in p:  # BasicBlock (resnet18)
        h = F.relu(_conv_bn(p["conv1"], x, stride=stride, padding=dilation, dilation=dilation))
        h = _conv_bn(p["conv2"], h, padding=dilation, dilation=dilation)
    else:
        h = F.relu(_conv_bn(p["conv1"], x))
        h = F.relu(_conv_bn(p["conv2"], h, stride=stride, padding=dilation, dilation=dilation))
        h = _conv_bn(p["conv3"], h)
    if "downsample" in p:
        identity = _conv_bn(p["downsample"], x, stride=stride, padding=0)
    return F.relu(identity + h)


def max_pool_3x3_s2(x):
    """3 x 3 max pool, stride 2, padded by one with -inf (NHWC)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, padding=1).permute(0, 2, 3, 1)


def resnet_features(p, x, output_stride: int | None = None):
    """{"stem", "c2" (/4), "c3" (/8), "c4" (/16), "c5" (/32, or dilated to
    /16 or /8 by ``output_stride``)}."""
    h = max_pool_3x3_s2(F.relu(_conv_bn(p["stem"], x, stride=2, padding=3)))
    feats = {"stem": h}
    strides, dilations = [1, 2, 2, 2], [1, 1, 1, 1]
    if output_stride == 16:
        strides[3], dilations[3] = 1, 2
    elif output_stride == 8:
        strides[2] = strides[3] = 1
        dilations[2], dilations[3] = 2, 4
    for i, stage in enumerate(p["layers"]):
        for j, blk in enumerate(stage):
            h = _bottleneck(blk, h, strides[i] if j == 0 else 1, dilations[i])
        feats[f"c{i + 2}"] = h
    return feats


def resnet_apply(p, images, preprocess_input: bool = True):
    """The classifier: [0, 1] NHWC -> logits (B, num_classes)."""
    x = preprocess(images) if preprocess_input else images
    pooled = resnet_features(p, x)["c5"].mean(dim=(1, 2))
    return L.linear(p["fc"], pooled)


def cross_entropy_loss(logits, labels):
    """Mean cross entropy over integer ``labels`` (B,), in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels[:, None].long()).mean()
