"""MUSIQ no-reference metric family (the port of ``unirestore_tpu/evalx/musiq.py``;
reference: eval_image_restoration.py:193-196 ``PyNRMetric('musiq')``,
'musiq-ava', 'musiq-paq2piq', 'musiq-spaq': one architecture, four
checkpoints).

MUSIQ (Ke et al., ICCV 2021), a multi-scale image quality transformer. The
image is taken at 3 scales (native, and aspect-preserving resizes with the
longer side 384 and 224; bilinear, ``ops/resize.py:resize_bilinear``), each
cut into 32 x 32 patches (zero-padded to a multiple of 32) projected to 384
dims. Each token gets a hash-based spatial embedding from a 10 x 10 learned
grid and a per-scale embedding; a class token is prepended, a 14-layer,
6-head transformer (MLP 1152) encodes the sequence, and the head maps the
class token to one score (KonIQ / PaQ-2-PiQ / SPAQ) or to a 10-bin
distribution whose expectation is the score (AVA).

The scale geometry is worked out on the host from the input's shape exactly
as in the JAX function (Python ``round`` in ``_arp_size``, the grid positions
in numpy in ``_hse_lookup``), so each image size has its own token count
(449 + 1 at 512 x 512). The tree has the JAX tree's keys and shapes. Inputs
are NHWC in [0, 1], not normalised.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..nn import layers as L
from ..ops.resize import resize_bilinear

HIDDEN = 384
LAYERS = 14
HEADS = 6
MLP = 1152
PATCH = 32
GRID = 10  # hash-based spatial embedding grid
SCALES = (0, 384, 224)  # 0 = native resolution


def _block_init(ini, dim):
    return {"norm1": L.norm_init(ini, dim),
            "qkv": L.linear_init(ini, dim, dim * 3),
            "proj": L.linear_init(ini, dim, dim),
            "norm2": L.norm_init(ini, dim),
            "fc1": L.linear_init(ini, dim, MLP),
            "fc2": L.linear_init(ini, MLP, dim)}


def musiq_init(ini, num_classes: int = 1):
    """The parameter tree (``ini``: an ``nn.init.Init``)."""
    return {"patch_proj": L.linear_init(ini, PATCH * PATCH * 3, HIDDEN),
            "cls_token": ini.zeros((1, 1, HIDDEN)),
            "hse": ini.normal((GRID, GRID, HIDDEN), 0.02),
            "scale_emb": ini.normal((len(SCALES), HIDDEN), 0.02),
            "blocks": [_block_init(ini, HIDDEN) for _ in range(LAYERS)],
            "norm": L.norm_init(ini, HIDDEN),
            "head": L.linear_init(ini, HIDDEN, num_classes)}


def _patchify(x):
    """(B, H, W, 3) -> (B, nh * nw, 32 * 32 * 3) and (nh, nw); zero-pads to /32."""
    b, h, w, c = x.shape
    ph, pw = (-h) % PATCH, (-w) % PATCH
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    nh, nw = (h + ph) // PATCH, (w + pw) // PATCH
    x = x.reshape(b, nh, PATCH, nw, PATCH, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, nh * nw, PATCH * PATCH * c)
    return x, (nh, nw)


def _grid_index(n: int) -> np.ndarray:
    """Each of ``n`` patch rows (or columns) hashed to a cell of the 10-cell axis."""
    if n == 1:
        return np.zeros(1, np.int32)
    return np.floor(np.arange(n) / max(n - 1, 1) * (GRID - 1) + 0.5).astype(np.int32)


_HSE_INDEX: dict = {}


def _hse_lookup(hse, nh, nw):
    """Hash each patch's normalised grid position into the G x G table; the
    index is made on the host once per (grid, device)."""
    key = (nh, nw, str(hse.device))
    if key not in _HSE_INDEX:
        ri, ci = _grid_index(nh), _grid_index(nw)
        flat = (ri[:, None] * GRID + ci[None, :]).reshape(-1).astype(np.int64)
        with torch.inference_mode(False):
            _HSE_INDEX[key] = torch.as_tensor(flat, device=hse.device)
    return hse.reshape(GRID * GRID, HIDDEN)[_HSE_INDEX[key]]  # (nh * nw, HIDDEN)


def _arp_size(h, w, longer):
    s = longer / max(h, w)
    return max(1, round(h * s)), max(1, round(w * s))


def musiq_tokens(p, images):
    """The (B, 1 + tokens, 384) sequence after the last LayerNorm."""
    b, h, w, _ = images.shape
    tokens = []
    for si, longer in enumerate(SCALES):
        x = images
        if longer:
            x = resize_bilinear(images, _arp_size(h, w, longer))
        t, (gh, gw) = _patchify(x)
        t = L.linear(p["patch_proj"], t)
        t = t + _hse_lookup(p["hse"], gh, gw).to(t.dtype)[None]
        t = t + p["scale_emb"][si].to(t.dtype)[None, None]
        tokens.append(t)
    t = torch.cat(tokens, dim=1)
    cls = p["cls_token"].to(t.dtype).expand(b, 1, HIDDEN)
    t = torch.cat([cls, t], dim=1)
    for blk in p["blocks"]:
        y = L.layer_norm(blk["norm1"], t, eps=1e-6)
        bq, n, c = y.shape
        d = c // HEADS
        qkv = L.linear(blk["qkv"], y).reshape(bq, n, 3, HEADS, d)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        logits = torch.einsum("bnhd,bmhd->bhnm", q, k) * (d ** -0.5)
        attn = torch.softmax(logits.float(), dim=-1).to(t.dtype)
        o = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(bq, n, c)
        t = t + L.linear(blk["proj"], o)
        m = L.layer_norm(blk["norm2"], t, eps=1e-6)
        t = t + L.linear(blk["fc2"], L.gelu(L.linear(blk["fc1"], m)))
    return L.layer_norm(p["norm"], t, eps=1e-6)


def musiq_head(p, cls, num_classes: int = 1):
    """The class token -> score; ``num_classes=10``: the AVA expectation."""
    out = L.linear(p["head"], cls).float()
    if num_classes == 1:
        return out[:, 0]
    probs = torch.softmax(out, dim=-1)
    bins = torch.arange(1, num_classes + 1, dtype=torch.float32, device=out.device)
    return (probs * bins).sum(dim=-1)


def musiq_score(p, images, num_classes: int = 1):
    """[0, 1] NHWC -> score per image."""
    return musiq_head(p, musiq_tokens(p, images)[:, 0], num_classes)
