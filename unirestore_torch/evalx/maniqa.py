"""MANIQA no-reference metric (the port of ``unirestore_tpu/evalx/maniqa.py``;
reference: eval_image_restoration.py:198 ``PyNRMetric('maniqa')``).

MANIQA (Yang et al., CVPRW 2022): ViT-B/8 at 224 px (785 tokens) gives the
token features of blocks 6-9 (0-indexed; the official model's
``save_output.outputs[6:10]``), concatenated to 4 x 768 over the 28 x 28
grid; transposed-attention blocks (attention across channels), a 1 x 1 conv
to 768, a 2-block Swin v1 stage (window 4, shift 2), another TA stage and
conv to 384 and Swin stage, then per-patch score and weight MLPs; the score
is the weight-averaged patch score. The ViT blocks are
``tasks/vit.py:_attention``'s and the Swin stages
``tasks/swin.py:_window_attention``'s. The tree has the JAX tree's keys and
shapes. Inputs are NHWC in [0, 1], resized to 224 px and ImageNet-normalised.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..nn import layers as L
from ..tasks import resnet as RN
from ..tasks import swin as SW
from ..tasks import vit as VIT

EMBED = 768
DEPTH = 12
HEADS = 12
PATCH = 8
GRID = 224 // PATCH  # 28
FEAT_LAYERS = (6, 7, 8, 9)
SWIN_HEADS = 4
WINDOW = 4


def _vit_b8_init(ini):
    return {"patch": L.conv2d_init(ini, 3, EMBED, PATCH),
            "cls_token": ini.zeros((1, 1, EMBED)),
            "pos_embed": ini.normal((1, GRID * GRID + 1, EMBED), 0.02),
            "blocks": [VIT._block_init(ini, EMBED) for _ in range(DEPTH)]}


def _ta_block_init(ini, dim):
    return {"q": L.linear_init(ini, dim, dim, bias=False),
            "k": L.linear_init(ini, dim, dim, bias=False),
            "v": L.linear_init(ini, dim, dim, bias=False),
            "proj": L.linear_init(ini, dim, dim)}


def _swin_block_init(ini, dim, heads):
    return SW._block_init(ini, dim, heads, WINDOW, v2=False)


def maniqa_init(ini):
    """The parameter tree (``ini``: an ``nn.init.Init``)."""
    dim_spatial = GRID * GRID  # the TA blocks attend over channels: "dim" = H * W
    return {"vit": _vit_b8_init(ini),
            "ta1": [_ta_block_init(ini, dim_spatial) for _ in range(2)],
            "conv1": L.conv2d_init(ini, EMBED * len(FEAT_LAYERS), EMBED, 1),
            "swin1": [_swin_block_init(ini, EMBED, SWIN_HEADS) for _ in range(2)],
            "ta2": [_ta_block_init(ini, dim_spatial) for _ in range(2)],
            "conv2": L.conv2d_init(ini, EMBED, EMBED // 2, 1),
            "swin2": [_swin_block_init(ini, EMBED // 2, SWIN_HEADS) for _ in range(2)],
            "score_fc1": L.linear_init(ini, EMBED // 2, EMBED // 2),
            "score_fc2": L.linear_init(ini, EMBED // 2, 1),
            "weight_fc1": L.linear_init(ini, EMBED // 2, EMBED // 2),
            "weight_fc2": L.linear_init(ini, EMBED // 2, 1)}


def _vit_features(p, x):
    """The concatenated token features of FEAT_LAYERS, (B, 28, 28, 4 * 768)."""
    h = L.conv2d(p["patch"], x, stride=PATCH, padding="VALID")
    b, hh, ww, c = h.shape
    t = h.reshape(b, hh * ww, c)
    cls = p["cls_token"].to(t.dtype).expand(b, 1, c)
    t = torch.cat([cls, t], dim=1) + p["pos_embed"].to(t.dtype)
    feats = []
    for i, blk in enumerate(p["blocks"][:max(FEAT_LAYERS) + 1]):
        t = t + VIT._attention(blk, L.layer_norm(blk["norm1"], t, eps=1e-6))
        m = L.layer_norm(blk["norm2"], t, eps=1e-6)
        t = t + L.linear(blk["fc2"], L.gelu(L.linear(blk["fc1"], m)))
        if i in FEAT_LAYERS:
            feats.append(t[:, 1:])  # without the class token
    return torch.cat(feats, dim=-1).reshape(b, hh, ww, -1)


def _ta(p, x):
    """Transposed attention: tokens are channels, dim is space, (B, C, HW)."""
    q = L.linear(p["q"], x)
    k = L.linear(p["k"], x)
    v = L.linear(p["v"], x)
    logits = torch.einsum("bcd,bed->bce", q, k) * (x.shape[-1] ** -0.5)
    attn = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    o = torch.einsum("bce,bed->bcd", attn, v)
    return x + L.linear(p["proj"], o)


def _ta_stage(blocks, x):
    """(B, H, W, C) -> TA over channels -> the same shape."""
    b, h, w, c = x.shape
    t = x.reshape(b, h * w, c).transpose(1, 2)  # (B, C, HW)
    for blk in blocks:
        t = _ta(blk, t)
    return t.transpose(1, 2).reshape(b, h, w, c)


def _swin_stage(blocks, x):
    for j, blk in enumerate(blocks):
        shift = 0 if j % 2 == 0 else WINDOW // 2
        x = x + SW._window_attention(blk, L.layer_norm(blk["norm1"], x, eps=1e-5), WINDOW,
                                     shift, SWIN_HEADS, v2=False)
        m = L.layer_norm(blk["norm2"], x, eps=1e-5)
        x = x + L.linear(blk["fc2"], L.gelu(L.linear(blk["fc1"], m)))
    return x


def maniqa_features(p, images, preprocess_input: bool = True):
    """The (B, 28, 28, 384) map the score and weight heads read."""
    x = RN.preprocess(images) if preprocess_input else images
    f = _vit_features(p["vit"], x)  # (B, 28, 28, 3072)
    f = _ta_stage(p["ta1"], f)
    f = L.conv2d(p["conv1"], f)
    f = _swin_stage(p["swin1"], f)
    f = _ta_stage(p["ta2"], f)
    f = L.conv2d(p["conv2"], f)
    return _swin_stage(p["swin2"], f)


def maniqa_head(p, f):
    t = f.reshape(f.shape[0], -1, f.shape[-1]).float()
    score = F.relu(L.linear(p["score_fc2"], F.relu(L.linear(p["score_fc1"], t))))[..., 0]
    weight = torch.sigmoid(L.linear(p["weight_fc2"], F.relu(L.linear(p["weight_fc1"], t))))[..., 0]
    return (score * weight).sum(-1) / torch.clamp(weight.sum(-1), min=1e-8)


def maniqa_score(p, images, preprocess_input: bool = True):
    """[0, 1] NHWC -> quality score per image (~[0, 1])."""
    return maniqa_head(p, maniqa_features(p, images, preprocess_input))
