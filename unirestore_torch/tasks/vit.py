"""ViT-B/16 classifier probe, NHWC (the port of ``unirestore_tpu/tasks/vit.py``).

torchvision ``vit_b_16`` (the ``all`` / ``all_ft`` sets' ``vit``) and timm
``vit_base_patch16_224`` fine-tuned on CUB-200 (``cub_vitb``). Pre-norm: a
16x16/16 patch convolution, a class token and a fixed-size position
embedding (``TOKENS`` = 197, so the input is the 224 px image of
``resnet.preprocess``), 12 blocks of LayerNorm (eps 1e-6) -> 12-head
attention -> residual and LayerNorm -> MLP (3072, exact GELU) -> residual,
a final LayerNorm and a linear head on the class token. Attention keeps the
JAX arithmetic: einsum, softmax in fp32 cast back, einsum. The tree has the
JAX tree's keys and shapes.
"""

from __future__ import annotations

import torch

from ..nn import layers as L
from . import resnet as RN

EMBED = 768
HEADS = 12
DEPTH = 12
MLP = 3072
PATCH = 16
TOKENS = (224 // PATCH) ** 2 + 1  # 197 with class token


def _block_init(ini, dim, mlp: int = MLP):
    return {"norm1": L.norm_init(ini, dim),
            "qkv": L.linear_init(ini, dim, dim * 3),
            "proj": L.linear_init(ini, dim, dim),
            "norm2": L.norm_init(ini, dim),
            "fc1": L.linear_init(ini, dim, mlp),
            "fc2": L.linear_init(ini, mlp, dim)}


def vit_b16_init(ini, num_classes: int = 1000):
    """The parameter tree (``ini``: an ``nn.init.Init``)."""
    return {"patch": L.conv2d_init(ini, 3, EMBED, PATCH),
            "cls_token": ini.zeros((1, 1, EMBED)),
            "pos_embed": ini.normal((1, TOKENS, EMBED), 0.02),
            "blocks": [_block_init(ini, EMBED) for _ in range(DEPTH)],
            "norm": L.norm_init(ini, EMBED),
            "head": L.linear_init(ini, EMBED, num_classes)}


def _attention(p, x, heads: int = HEADS, logit_gate=None):
    """Multi-head self-attention over (B, N, C); ``logit_gate`` (heads, N, N)
    multiplies the scaled logits before the softmax (RVT's masked blocks)."""
    b, n, c = x.shape
    d = c // heads
    qkv = L.linear(p["qkv"], x).reshape(b, n, 3, heads, d)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k) * (d ** -0.5)
    if logit_gate is not None:
        logits = logits * logit_gate.to(logits.dtype)
    attn = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    o = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, n, c)
    return L.linear(p["proj"], o)


def vit_b16_apply(p, images, preprocess_input: bool = True):
    """[0, 1] NHWC -> logits; resizes to 224 px inside."""
    x = RN.preprocess(images) if preprocess_input else images
    h = L.conv2d(p["patch"], x, stride=PATCH, padding="VALID")
    b, hh, ww, c = h.shape
    t = h.reshape(b, hh * ww, c)
    cls = p["cls_token"].to(t.dtype).expand(b, 1, c)
    t = torch.cat([cls, t], dim=1) + p["pos_embed"].to(t.dtype)
    for blk in p["blocks"]:
        t = t + _attention(blk, L.layer_norm(blk["norm1"], t, eps=1e-6))
        m = L.layer_norm(blk["norm2"], t, eps=1e-6)
        t = t + L.linear(blk["fc2"], L.gelu(L.linear(blk["fc1"], m)))
    t = L.layer_norm(p["norm"], t, eps=1e-6)
    return L.linear(p["head"], t[:, 0])
