"""DeepLabV3+ over a ResNet backbone (the port of ``unirestore_tpu/tasks/deeplab.py``).

The frozen segmentation critic of stage 2 and the ``dlv3pr50`` validation
probe: ``deeplabv3plus_resnet50`` with 19 classes at output stride 16. ASPP
at atrous rates 6/12/18 with the image-pooling branch, the 48-channel
low-level projection, the 3x3 decoder, and the logits resized bilinearly to
the input size. NHWC, inference BatchNorm, the JAX tree's keys and shapes
(conv kernels OIHW; the backbone is ``resnet_init``'s tree without ``fc``).

Only the ResNet backbones are ported: ``mobilenetv2``, ``xception`` and the
HRNets (``unirestore_tpu/tasks/backbones.py``) raise (ROADMAP Queue A 5).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..nn import layers as L
from ..ops.resize import resize_bilinear
from . import resnet as RN

ASPP_RATES = (6, 12, 18)

# backbone -> (high-level channels, low-level channels)
BACKBONE_CHANNELS = {
    "resnet50": (2048, 256), "resnet101": (2048, 256),
    "mobilenetv2": (320, 24), "xception": (2048, 128),
    "hrnetv2_48": (720, 256), "hrnetv2_32": (480, 256),
}
RESNET_BACKBONES = ("resnet50", "resnet101")


def _require_resnet(backbone: str):
    if backbone not in BACKBONE_CHANNELS:
        raise ValueError(f"unknown deeplab backbone {backbone}")
    if backbone not in RESNET_BACKBONES:
        raise NotImplementedError(f"deeplab backbone {backbone!r} is not ported yet "
                                  "(ROADMAP Queue A 5); the port has the ResNet backbones")


def _conv_bn_init(ini, cin, cout, k):
    return {"conv": L.conv2d_init(ini, cin, cout, k, bias=False), "bn": RN.bn_init(ini, cout)}


def deeplabv3plus_init(ini, num_classes: int = 19, backbone: str = "resnet50",
                       plus: bool = True):
    """The parameter tree (``ini``: an ``nn.init.Init``)."""
    _require_resnet(backbone)
    p = {"backbone": RN.resnet_init(ini, backbone)}
    del p["backbone"]["fc"]
    c_high, c_low = BACKBONE_CHANNELS[backbone]
    p["aspp"] = {
        "conv1x1": _conv_bn_init(ini, c_high, 256, 1),
        "atrous": [_conv_bn_init(ini, c_high, 256, 3) for _ in ASPP_RATES],
        "pool": _conv_bn_init(ini, c_high, 256, 1),
        "project": _conv_bn_init(ini, 256 * (2 + len(ASPP_RATES)), 256, 1),
    }
    if plus:  # the low-level fusion decoder
        p["low_proj"] = _conv_bn_init(ini, c_low, 48, 1)
        p["decoder"] = _conv_bn_init(ini, 256 + 48, 256, 3)
    else:
        p["decoder"] = _conv_bn_init(ini, 256, 256, 3)
    p["classifier"] = L.conv2d_init(ini, 256, num_classes, 1)
    return p


def _cb(p, x, padding="SAME", dilation=1):
    x = L.conv2d(p["conv"], x, padding=padding, dilation=dilation)
    return F.relu(RN.batch_norm(p["bn"], x))


def deeplabv3plus_apply(p, images, preprocess_input: bool = True,
                        backbone: str = "resnet50", output_stride: int = 16):
    """[0, 1] NHWC images -> logits at the input size (B, H, W, classes)."""
    _require_resnet(backbone)
    h_in, w_in = images.shape[1:3]
    x = RN.normalize(images) if preprocess_input else images
    feats = RN.resnet_features(p["backbone"], x, output_stride=output_stride)
    high, low = feats["c5"], feats["c2"]

    branches = [_cb(p["aspp"]["conv1x1"], high, padding=0)]
    for rate, bp in zip(ASPP_RATES, p["aspp"]["atrous"]):
        branches.append(_cb(bp, high, padding=rate, dilation=rate))
    pooled = _cb(p["aspp"]["pool"], high.mean(dim=(1, 2), keepdim=True), padding=0)
    branches.append(pooled.expand(*high.shape[:3], pooled.shape[-1]))
    y = _cb(p["aspp"]["project"], torch.cat(branches, dim=-1), padding=0)

    if "low_proj" in p:
        y = resize_bilinear(y, (low.shape[1], low.shape[2]))
        y = _cb(p["decoder"], torch.cat([y, _cb(p["low_proj"], low, padding=0)], dim=-1))
    else:
        y = _cb(p["decoder"], y)
    logits = L.conv2d(p["classifier"], y, padding=0)
    return resize_bilinear(logits, (h_in, w_in))


def deeplab_factory(name: str, num_classes: int = 19, output_stride: int = 16):
    """(init_fn(ini), apply_fn(p, images)) for a ``modeling.py`` name such as
    ``deeplabv3plus_resnet50``; the other backbones raise."""
    plus = name.startswith("deeplabv3plus_")
    backbone = name.split("_", 1)[1]
    backbone = {"mobilenet": "mobilenetv2"}.get(backbone, backbone)
    if backbone not in BACKBONE_CHANNELS:
        raise ValueError(f"unknown deeplab variant {name}")
    _require_resnet(backbone)

    def init_fn(ini):
        return deeplabv3plus_init(ini, num_classes, backbone, plus=plus)

    def apply_fn(p, images, preprocess_input: bool = True):
        return deeplabv3plus_apply(p, images, preprocess_input, backbone=backbone,
                                   output_stride=output_stride)

    return init_fn, apply_fn


def seg_cross_entropy_loss(logits, labels, ignore_index: int = 255):
    """Cross entropy over NHWC logits and (B, H, W) integer labels: the mean
    over the pixels not labelled ``ignore_index`` (at least one)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (nll * valid).sum() / valid.sum().clamp(min=1)
