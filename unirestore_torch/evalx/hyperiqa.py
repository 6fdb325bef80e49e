"""HyperIQA no-reference metric (the port of ``unirestore_tpu/evalx/hyperiqa.py``;
reference: eval_image_restoration.py:198 ``PyNRMetric('hyperiqa')``).

HyperIQA (Su et al., CVPR 2020): a ResNet-50 backbone (``tasks/resnet.py``)
gives (a) a 224-d multi-scale "local distortion aware" content vector (conv,
pool and linear heads after stages 1-4) and (b) a 112-channel hyper feature
map from stage 4; a hyper network generates the weights and biases of a
small target network (224-112-56-28-14-1, sigmoid activations) that scores
the content vector per image, on a ~[0, 100] MOS scale.

The tree has the JAX tree's keys and shapes (conv kernels OIHW). Inputs are
NHWC in [0, 1], resized to 224 px and ImageNet-normalised. The two flattens
that feed linear maps (the LDA heads' pooled maps and the generated target
weights) are channel-major as in torch: the NHWC tensor goes to NCHW before
the reshape, or the generated weights land in the wrong places.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..nn import layers as L
from ..tasks import resnet as RN

LDA_OUT = 16
HYPER_CH = 112
TARGET_IN = 224
FCS = (112, 56, 28, 14)
FEAT = 7  # the hyper feature map's side


def hyperiqa_init(ini):
    """The parameter tree (``ini``: an ``nn.init.Init``)."""
    p = {
        # ResNet-50 features (the backbone's fc head is unused)
        "backbone": RN.resnet_init(ini, "resnet50"),
        # LDA heads: 1x1 conv, 7-stride average pool, linear -> 16 each;
        # stage 4: pooled linear -> 224 - 3 * 16 = 176
        "lda1_conv": L.conv2d_init(ini, 256, 16, 1),
        "lda1_fc": L.linear_init(ini, 16 * 64, LDA_OUT),
        "lda2_conv": L.conv2d_init(ini, 512, 32, 1),
        "lda2_fc": L.linear_init(ini, 32 * 16, LDA_OUT),
        "lda3_conv": L.conv2d_init(ini, 1024, 64, 1),
        "lda3_fc": L.linear_init(ini, 64 * 4, LDA_OUT),
        "lda4_fc": L.linear_init(ini, 2048, TARGET_IN - 3 * LDA_OUT),
        # hyper feature: 2048 -> 1024 -> 512 -> 112 (1x1 convs and relu)
        "hconv1": L.conv2d_init(ini, 2048, 1024, 1),
        "hconv2": L.conv2d_init(ini, 1024, 512, 1),
        "hconv3": L.conv2d_init(ini, 512, HYPER_CH, 1),
    }
    # weight-generating 3x3 convs (the 7 x 7 map folds into the fan-in) and
    # bias-generating linears on the pooled hyper vector
    sizes = (TARGET_IN,) + FCS
    for i in range(4):
        fin, fout = sizes[i], sizes[i + 1]
        p[f"fc{i + 1}w_conv"] = L.conv2d_init(ini, HYPER_CH, fin * fout // (FEAT * FEAT), 3)
        p[f"fc{i + 1}b_fc"] = L.linear_init(ini, HYPER_CH, fout)
    p["fc5w_fc"] = L.linear_init(ini, HYPER_CH, FCS[-1])
    p["fc5b_fc"] = L.linear_init(ini, HYPER_CH, 1)
    return p


def _avgpool7(x):
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 7, 7).permute(0, 2, 3, 1)


def _lda(conv, fc, x):
    h = _avgpool7(L.conv2d(conv, x, padding=0))
    flat = h.permute(0, 3, 1, 2).reshape(h.shape[0], -1)  # torch's NCHW flatten
    return L.linear(fc, flat)


def hyperiqa_content(p, images, preprocess_input: bool = True):
    """(the 224-d content vector, the (B, 7, 7, 112) hyper feature map)."""
    x = RN.preprocess(images) if preprocess_input else images
    feats = RN.resnet_features(p["backbone"], x)
    b = x.shape[0]
    content = torch.cat([
        _lda(p["lda1_conv"], p["lda1_fc"], feats["c2"]),
        _lda(p["lda2_conv"], p["lda2_fc"], feats["c3"]),
        _lda(p["lda3_conv"], p["lda3_fc"], feats["c4"]),
        L.linear(p["lda4_fc"], _avgpool7(feats["c5"]).reshape(b, -1)),
    ], dim=-1)
    h = F.relu(L.conv2d(p["hconv1"], feats["c5"]))
    h = F.relu(L.conv2d(p["hconv2"], h))
    return content, F.relu(L.conv2d(p["hconv3"], h))


def hyperiqa_score(p, images, preprocess_input: bool = True):
    """[0, 1] NHWC -> quality score per image (~[0, 100] MOS scale)."""
    content, hyper = hyperiqa_content(p, images, preprocess_input)
    b = hyper.shape[0]
    pooled = hyper.mean(dim=(1, 2))  # (B, 112)
    v = content.float()
    sizes = (TARGET_IN,) + FCS
    for i in range(4):
        fin, fout = sizes[i], sizes[i + 1]
        wmap = L.conv2d(p[f"fc{i + 1}w_conv"], hyper, padding=1)
        # (B, 7, 7, fin * fout / 49) -> channel-major flatten -> (B, fout, fin)
        w = wmap.permute(0, 3, 1, 2).reshape(b, fout, fin)
        bias = L.linear(p[f"fc{i + 1}b_fc"], pooled)
        v = torch.sigmoid(torch.einsum("boi,bi->bo", w.float(), v) + bias.float())
    w5 = L.linear(p["fc5w_fc"], pooled).float()  # (B, 14)
    b5 = L.linear(p["fc5b_fc"], pooled).float()  # (B, 1)
    return (v * w5).sum(dim=-1) + b5[:, 0]
