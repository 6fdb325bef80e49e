"""VGG-16 classifier probe, NHWC (the port of ``unirestore_tpu/tasks/vgg.py``).

torchvision ``vgg16``: thirteen 3x3 convolutions in five stages, each stage
closed by a 2x2/2 max pool, then three linear layers. The ``all`` set's
``vgg`` probe and the ``all_ft`` set's ``vgg_ft``. The tree has the JAX
tree's keys and shapes (``features``: a list of stages, each a list of
``{"w", "b"}`` convolutions with OIHW kernels; ``fc1``-``fc3`` linear layers
with ``w`` of shape (in, out)). Inputs are NHWC in [0, 1], resized to 224 px
and ImageNet-normalised by ``resnet.preprocess``.
"""

from __future__ import annotations

import torch.nn.functional as F

from ..nn import layers as L
from . import resnet as RN

# torchvision vgg16 "D" configuration: conv channel plan between maxpools.
VGG16_PLAN = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
              (512, 512, 512))


def max_pool_2x2(x):
    """2 x 2 max pool, stride 2, no padding (NHWC)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def vgg16_init(ini, num_classes: int = 1000):
    """The parameter tree (``ini``: an ``nn.init.Init``)."""
    cin, stages = 3, []
    for plan in VGG16_PLAN:
        stage = []
        for cout in plan:
            stage.append(L.conv2d_init(ini, cin, cout, 3))
            cin = cout
        stages.append(stage)
    return {"features": stages,
            "fc1": L.linear_init(ini, 512 * 7 * 7, 4096),
            "fc2": L.linear_init(ini, 4096, 4096),
            "fc3": L.linear_init(ini, 4096, num_classes)}


def vgg16_features(p, x):
    h = x
    for stage in p["features"]:
        for conv in stage:
            h = F.relu(L.conv2d(conv, h, padding=1))
        h = max_pool_2x2(h)
    return h


def vgg16_apply(p, images, preprocess_input: bool = True):
    """[0, 1] NHWC -> logits (B, num_classes); resizes to 224 px inside."""
    x = RN.preprocess(images) if preprocess_input else images
    h = vgg16_features(p, x)  # (B, 7, 7, 512)
    # torch flattens NCHW, channel-major: the converted fc1 rows follow it
    flat = h.permute(0, 3, 1, 2).reshape(h.shape[0], -1)
    h = F.relu(L.linear(p["fc1"], flat))
    h = F.relu(L.linear(p["fc2"], h))
    return L.linear(p["fc3"], h)
