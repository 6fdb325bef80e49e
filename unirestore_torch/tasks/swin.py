"""Swin Transformer classifier probes, NHWC (the port of ``unirestore_tpu/tasks/swin.py``).

Two variants:
- ``swin_v2_b`` (torchvision, window 8; the ``all`` sets' ``swin``):
  res-post-norm blocks, cosine attention with a per-head ``logit_scale``
  clamped at log 100, and the continuous relative position bias (CPB MLP
  over log-spaced coordinates, ``16 * sigmoid``);
- ``swin_base_patch4_window7_224`` (timm, window 7; the CUB set's
  ``cub_swin``): pre-norm blocks, scaled dot-product attention and a learned
  relative-position-bias table.

Both: a 4x4/4 patch embedding, stages [2, 2, 18, 2] at dims [128, 256, 512,
1024] with heads [4, 8, 16, 32], shifted windows on odd blocks (no shift
where the window covers the padded map), patch merging between stages (v2
reduces then normalises, v1 the other way round), LayerNorm, the spatial
mean and a linear head. The tables and the shift mask are numpy, computed as
the JAX module computes them (its own copies: the port imports nothing of
the JAX package) and made once per device. The tree has the JAX tree's keys
and shapes.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..nn import layers as L
from . import resnet as RN

DEPTHS = (2, 2, 18, 2)
DIMS = (128, 256, 512, 1024)
HEADS = (4, 8, 16, 32)


@lru_cache(maxsize=None)
def _relative_position_index(window: int) -> np.ndarray:
    """(n, n) indices into the (2w-1)^2 relative bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, n, n)
    rel = rel.transpose(1, 2, 0) + (window - 1)
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).astype(np.int32)


@lru_cache(maxsize=None)
def _cpb_coords_table(window: int) -> np.ndarray:
    """Log-spaced normalized relative coords, ((2w-1)^2, 2) — SwinV2 CPB."""
    r = np.arange(-(window - 1), window, dtype=np.float64)
    table = np.stack(np.meshgrid(r, r, indexing="ij"), axis=-1)
    table = table / (window - 1) * 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / 3.0
    return table.reshape(-1, 2).astype(np.float32)


@lru_cache(maxsize=None)
def _shift_mask(hp: int, wp: int, window: int, shift: int) -> np.ndarray:
    """(num_windows, n, n) additive mask (0 / -100) for shifted windows."""
    img = np.zeros((hp, wp))
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    nh, nw = hp // window, wp // window
    wins = img.reshape(nh, window, nw, window).transpose(0, 2, 1, 3)
    wins = wins.reshape(nh * nw, window * window)
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff == 0, 0.0, -100.0).astype(np.float32)


_ON_DEVICE: dict = {}


def _on_device(table_fn, *args, device):
    """``table_fn(*args)`` (a numpy table above) as a tensor on ``device``, made once
    per (table, arguments, device); a normal tensor even under ``inference_mode``."""
    key = (table_fn.__name__, args, str(device))
    if key not in _ON_DEVICE:
        table = table_fn(*args)
        with torch.inference_mode(False):
            _ON_DEVICE[key] = torch.as_tensor(
                table.astype(np.int64) if table.dtype == np.int32 else table, device=device)
    return _ON_DEVICE[key]


def _block_init(ini, dim, heads, window, v2: bool):
    p = {"norm1": L.norm_init(ini, dim),
         "qkv": L.linear_init(ini, dim, dim * 3),
         "proj": L.linear_init(ini, dim, dim),
         "norm2": L.norm_init(ini, dim),
         "fc1": L.linear_init(ini, dim, dim * 4),
         "fc2": L.linear_init(ini, dim * 4, dim)}
    if v2:
        p["logit_scale"] = ini.full((heads, 1, 1), float(np.log(10.0)))
        p["cpb_fc1"] = L.linear_init(ini, 2, 512)
        p["cpb_fc2"] = L.linear_init(ini, 512, heads, bias=False)
    else:
        p["rel_bias"] = ini.normal(((2 * window - 1) ** 2, heads), 0.02)
    return p


def swin_base_init(ini, num_classes: int = 1000, v2: bool = True):
    """The parameter tree (``ini``: an ``nn.init.Init``)."""
    window = 8 if v2 else 7
    p = {"patch": L.conv2d_init(ini, 3, DIMS[0], 4),
         "patch_norm": L.norm_init(ini, DIMS[0]),
         "stages": [], "merge": [],
         "norm": L.norm_init(ini, DIMS[-1]),
         "head": L.linear_init(ini, DIMS[-1], num_classes)}
    for i, (depth, dim, heads) in enumerate(zip(DEPTHS, DIMS, HEADS)):
        if i > 0:
            p["merge"].append({
                # v2 norms after reduction (dim), v1 before (4x previous dim)
                "norm": L.norm_init(ini, dim if v2 else DIMS[i - 1] * 4),
                "reduction": L.linear_init(ini, DIMS[i - 1] * 4, dim, bias=False)})
        p["stages"].append([_block_init(ini, dim, heads, window, v2) for _ in range(depth)])
    return p


def _unit(t):
    """``t`` over its L2 norm on the last axis (fp32 norm, floored at 1e-12)."""
    norm = torch.linalg.vector_norm(t.float(), dim=-1, keepdim=True)
    return t / torch.clamp(norm, min=1e-12).to(t.dtype)


def _window_attention(p, x, window: int, shift: int, heads: int, v2: bool):
    b, h, w, c = x.shape
    d = c // heads
    pad_b = (window - h % window) % window
    pad_r = (window - w % window) % window
    if pad_b or pad_r:
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    hp, wp = h + pad_b, w + pad_r
    sh = shift if window < hp else 0
    sw = shift if window < wp else 0
    if sh or sw:
        x = torch.roll(x, (-sh, -sw), dims=(1, 2))
    nh, nw = hp // window, wp // window
    n = window * window
    xw = x.reshape(b, nh, window, nw, window, c)
    xw = xw.permute(0, 1, 3, 2, 4, 5).reshape(b * nh * nw, n, c)

    qkv = L.linear(p["qkv"], xw).reshape(-1, n, 3, heads, d)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (bw, n, h, d)
    if v2:
        q, k = _unit(q), _unit(k)
        scale = torch.exp(torch.clamp(p["logit_scale"].float(), max=float(np.log(100.0))))
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale.reshape(1, heads, 1, 1).to(q.dtype)
        table = _on_device(_cpb_coords_table, window, device=x.device)
        cpb = L.linear(p["cpb_fc2"], F.relu(L.linear(p["cpb_fc1"], table)))
        bias = 16.0 * torch.sigmoid(cpb)  # ((2w-1)^2, heads)
    else:
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k) * (d ** -0.5)
        bias = p["rel_bias"]
    idx = _on_device(_relative_position_index, window, device=x.device)
    attn = attn + bias[idx].permute(2, 0, 1).to(attn.dtype)[None]
    if sh or sw:
        mask = _on_device(_shift_mask, hp, wp, window, shift, device=x.device)
        attn = attn.reshape(b, nh * nw, heads, n, n) + mask[None, :, None].to(attn.dtype)
        attn = attn.reshape(b * nh * nw, heads, n, n)
    attn = torch.softmax(attn.float(), dim=-1).to(xw.dtype)
    o = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(-1, n, c)
    o = L.linear(p["proj"], o)

    o = o.reshape(b, nh, nw, window, window, c)
    o = o.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
    if sh or sw:
        o = torch.roll(o, (sh, sw), dims=(1, 2))
    return o[:, :h, :w]


def _patch_merge(p, x, v2: bool):
    h, w = x.shape[1:3]
    if h % 2 or w % 2:  # torchvision pads odd dims before merging
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                  dim=-1)
    if v2:  # reduction then norm (PatchMergingV2)
        return L.layer_norm(p["norm"], L.linear(p["reduction"], x), eps=1e-5)
    return L.linear(p["reduction"], L.layer_norm(p["norm"], x, eps=1e-5))


def swin_base_apply(p, images, preprocess_input: bool = True, v2: bool = True):
    """[0, 1] NHWC -> logits; resizes to 224 px inside."""
    window = 8 if v2 else 7
    x = RN.preprocess(images) if preprocess_input else images
    h = L.conv2d(p["patch"], x, stride=4, padding="VALID")
    h = L.layer_norm(p["patch_norm"], h, eps=1e-5)
    for i, (stage, heads) in enumerate(zip(p["stages"], HEADS)):
        if i > 0:
            h = _patch_merge(p["merge"][i - 1], h, v2)
        for j, blk in enumerate(stage):
            shift = 0 if j % 2 == 0 else window // 2
            if v2:  # res-post-norm
                a = _window_attention(blk, h, window, shift, heads, v2)
                h = h + L.layer_norm(blk["norm1"], a, eps=1e-5)
                m = L.linear(blk["fc2"], L.gelu(L.linear(blk["fc1"], h)))
                h = h + L.layer_norm(blk["norm2"], m, eps=1e-5)
            else:  # pre-norm
                a = _window_attention(blk, L.layer_norm(blk["norm1"], h, eps=1e-5),
                                      window, shift, heads, v2)
                h = h + a
                m = L.layer_norm(blk["norm2"], h, eps=1e-5)
                h = h + L.linear(blk["fc2"], L.gelu(L.linear(blk["fc1"], m)))
    h = L.layer_norm(p["norm"], h, eps=1e-5)
    return L.linear(p["head"], h.mean(dim=(1, 2)))
