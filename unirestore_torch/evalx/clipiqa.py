"""CLIP-IQA no-reference metric (the port of ``unirestore_tpu/evalx/clipiqa.py``;
reference: eval_image_restoration.py:192 ``PyNRMetric('clipiqa')``).

CLIP-IQA (Wang et al., AAAI 2023): the score is the softmax over the cosine
similarities between the CLIP RN50 image embedding and a frozen antonym
prompt pair ("Good photo." / "Bad photo."); the "good" probability is the
quality score in [0, 1]. The image tower is CLIP's ModifiedResNet-50: a
3-conv stem, average-pool downsampling, 4 bottleneck stages and attention
pooling to a 1024-d embedding. The two text embeddings are data (in the
weights file, ``tools/convert_clip.py``): the text tower never runs.

The tree has the JAX tree's keys and shapes (conv kernels OIHW). Inputs are
NHWC in [0, 1]: the short side is resized to 224 (bicubic), the centre
224 x 224 cropped and normalised with CLIP's statistics. ``stem1`` is the
JAX function's ``"SAME"`` convolution at stride 2, which pads (0, 1) on a
224 px input, not 1 on each side: its padding is worked out here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..nn import layers as L
from ..ops.resize import resize_bicubic
from ..tasks import resnet as RN

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

BLOCKS = (3, 4, 6, 3)
WIDTH = 64
EMBED = 1024
HEADS = 32


def same_padding(size: int, kernel: int, stride: int) -> tuple:
    """(before, after) of XLA's ``"SAME"`` padding along one axis: the output is
    ceil(size / stride) long and the odd pixel of padding goes after."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _cbn_init(ini, cin, cout, k):
    return {"conv": L.conv2d_init(ini, cin, cout, k, bias=False), "bn": RN.bn_init(ini, cout)}


def _bottleneck_init(ini, cin, cout, stride):
    width = cout // 4
    p = {"conv1": _cbn_init(ini, cin, width, 1),
         "conv2": _cbn_init(ini, width, width, 3),
         "conv3": _cbn_init(ini, width, cout, 1)}
    if stride > 1 or cin != cout:
        p["down"] = _cbn_init(ini, cin, cout, 1)
    return p


def clip_rn50_init(ini, embed: int = EMBED):
    """The parameter tree (``ini``: an ``nn.init.Init``)."""
    p = {"stem1": _cbn_init(ini, 3, WIDTH // 2, 3),
         "stem2": _cbn_init(ini, WIDTH // 2, WIDTH // 2, 3),
         "stem3": _cbn_init(ini, WIDTH // 2, WIDTH, 3),
         "layers": [],
         # attention pool: a learned position embedding over 7 * 7 + 1 tokens,
         # separate q / k / v / out projections
         "attnpool": {"pos": ini.normal((50, WIDTH * 32), 0.02),
                      "q": L.linear_init(ini, WIDTH * 32, WIDTH * 32),
                      "k": L.linear_init(ini, WIDTH * 32, WIDTH * 32),
                      "v": L.linear_init(ini, WIDTH * 32, WIDTH * 32),
                      "out": L.linear_init(ini, WIDTH * 32, embed)},
         # the antonym prompt pair's text embeddings, made offline
         "text_features": ini.normal((2, embed), 0.02)}
    cin = WIDTH
    for i, n in enumerate(BLOCKS):
        cout = WIDTH * 4 * (2 ** i)
        stage = []
        for j in range(n):
            stage.append(_bottleneck_init(ini, cin, cout, 2 if (j == 0 and i > 0) else 1))
            cin = cout
        p["layers"].append(stage)
    return p


def _avg_pool2(x, stride=2):
    return F.avg_pool2d(x.permute(0, 3, 1, 2), stride, stride).permute(0, 2, 3, 1)


def _cbn(p, x, **kw):
    return RN.batch_norm(p["bn"], L.conv2d(p["conv"], x, **kw))


def _bottleneck(p, x, stride=1):
    h = F.relu(_cbn(p["conv1"], x))
    h = F.relu(_cbn(p["conv2"], h))
    if stride > 1:  # CLIP: average pool, then the stride-1 convolution
        h = _avg_pool2(h, stride)
    h = _cbn(p["conv3"], h)
    identity = x
    if "down" in p:
        if stride > 1:
            identity = _avg_pool2(identity, stride)
        identity = _cbn(p["down"], identity)
    return F.relu(identity + h)


def _attn_pool(p, x):
    b, h, w, c = x.shape
    t = x.reshape(b, h * w, c)
    t = torch.cat([t.mean(dim=1, keepdim=True), t], dim=1) + p["pos"].to(t.dtype)[None]
    q = L.linear(p["q"], t[:, :1])
    k = L.linear(p["k"], t)
    v = L.linear(p["v"], t)
    d = c // HEADS
    q = q.reshape(b, 1, HEADS, d)
    k = k.reshape(b, -1, HEADS, d)
    v = v.reshape(b, -1, HEADS, d)
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k) * (d ** -0.5)
    attn = torch.softmax(logits.float(), dim=-1).to(t.dtype)
    o = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, 1, c)
    return L.linear(p["out"], o)[:, 0]


_STATS: dict = {}


def preprocess(images, size: int = 224):
    """Resize the short side to ``size`` (bicubic), crop the centre size^2,
    clamp to [0, 1] and normalise with CLIP's statistics (copied to the device
    once per dtype and device)."""
    b, h, w, c = images.shape
    s = size / min(h, w)
    nh, nw = max(size, round(h * s)), max(size, round(w * s))
    x = resize_bicubic(images, (nh, nw))
    top, left = (nh - size) // 2, (nw - size) // 2
    x = x[:, top:top + size, left:left + size]
    key = (x.dtype, str(x.device))
    if key not in _STATS:
        with torch.inference_mode(False):
            _STATS[key] = tuple(torch.tensor(v, dtype=x.dtype, device=x.device)
                                for v in (CLIP_MEAN, CLIP_STD))
    mean, std = _STATS[key]
    return (torch.clamp(x, 0, 1) - mean) / std


def image_features(p, images, preprocess_input: bool = True):
    """The 1024-d image embedding (before the unit normalisation)."""
    x = preprocess(images) if preprocess_input else images
    pad = (same_padding(x.shape[1], 3, 2), same_padding(x.shape[2], 3, 2))
    h = F.relu(_cbn(p["stem1"], x, stride=2, padding=pad))
    h = F.relu(_cbn(p["stem2"], h))
    h = F.relu(_cbn(p["stem3"], h))
    h = _avg_pool2(h, 2)
    for i, stage in enumerate(p["layers"]):
        for j, blk in enumerate(stage):
            h = _bottleneck(blk, h, 2 if (j == 0 and i > 0) else 1)
    return _attn_pool(p["attnpool"], h)


def clipiqa_score(p, images):
    """[0, 1] NHWC -> quality score in [0, 1] per image."""
    feat = image_features(p, images).float()
    feat = feat / torch.linalg.vector_norm(feat, dim=-1, keepdim=True)
    txt = p["text_features"].float()
    txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
    logits = 100.0 * feat @ txt.T  # (B, 2): [good, bad]
    return torch.softmax(logits, dim=-1)[:, 0]
