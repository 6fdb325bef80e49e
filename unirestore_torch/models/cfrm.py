"""CFRM: Controllable Feature Restoration Modules (mirrors ``unirestore_tpu/models/cfrm.py``).

A stage is N NAFBlocks followed by one AdaNAFV2 block: 1x1 expand x4 ->
GroupNorm(16) -> grouped 3x3 (16 groups) -> GELU -> intra-group SE ->
inter-group attention -> 1x1 project -> residual -> NAFBlock. The grouped 3x3
goes through the hand-written kernel ``nn/grouped_conv.py:grouped_conv3`` (the
port of the TPU kernel ``pallas_grouped_conv.py``) for every shape its
``supported`` admits, which includes the sd-turbo widths (dw = 512 / 1024 /
2048, 32 / 64 / 128 channels per group); other shapes, such as the tiny test
configs, take ``F.conv2d(groups=16)``. The choice is by shape alone.
"""

from __future__ import annotations

from ..nn import grouped_conv as GC
from ..nn import layers as L
from ..nn import remat as RM
from ..parallel import spatial as SP
from .nafnet import naf_block, naf_block_init

GROUPS = 16
EXPAND = 4


def ada_naf_v2_init(ini, c: int):
    dw = c * EXPAND
    return {
        "conv_in": L.conv2d_init(ini, c, dw, 1),
        "group_norm": L.norm_init(ini, dw),
        "group_conv": L.conv2d_init(ini, dw, dw, 3, groups=GROUPS),
        "intra_attn": L.conv2d_init(ini, dw, dw, 1, groups=GROUPS),
        "inter_attn": L.conv2d_init(ini, dw, GROUPS, 1),
        "pwconv": L.conv2d_init(ini, dw, c, 1),
        "nafblock": naf_block_init(ini, c),
    }


def _grouped_conv3(p, x):
    """The AdaNAF grouped 3x3: the kernel where it takes the shape, else cuDNN's.

    On a height-sharded slab (``parallel/spatial.py``) the kernel runs on the
    slab with a halo row of each neighbour, (B, h + 2, W, C), and the first and
    last output rows, which read the kernel's own zero padding, are dropped."""
    if GC.supported(x.shape, p["w"].shape, GROUPS):
        b = p["b"].to(x.dtype) if "b" in p else None
        if SP.current() is None:
            return GC.grouped_conv3(x, p["w"].to(x.dtype), b, GROUPS)
        return GC.grouped_conv3(SP.halo(x, 1, 1), p["w"].to(x.dtype), b, GROUPS)[:, 1:-1]
    return L.conv2d(p, x, padding=1, groups=GROUPS)


def ada_naf_v2(p, x):
    dw = p["conv_in"]["w"].shape[0]
    h = L.conv2d(p["conv_in"], x, padding=0)
    h = L.group_norm(p["group_norm"], h, groups=GROUPS, eps=1e-5)
    h = L.gelu(_grouped_conv3(p["group_conv"], h))
    # intra-group SE: grouped 1x1 on the global-average-pooled vector
    h = h * L.conv2d(p["intra_attn"], L.global_avg_pool(h), padding=0, groups=GROUPS)
    # inter-group attention: one scalar per channel-group
    iga = L.conv2d(p["inter_attn"], L.global_avg_pool(h), padding=0)  # (B,1,1,G)
    b, hh, ww, _ = h.shape
    h = (h.reshape(b, hh, ww, GROUPS, dw // GROUPS) * iga[..., None]).reshape(b, hh, ww, dw)
    h = L.conv2d(p["pwconv"], h, padding=0)
    return naf_block(p["nafblock"], x + h)


def cfrm_stage_init(ini, c: int, num_naf: int):
    return {
        "naf": [naf_block_init(ini, c) for _ in range(num_naf)],
        "ada": ada_naf_v2_init(ini, c),
    }


def cfrm_stage(p, x, remat: bool = False):
    """With ``remat`` each NAF/AdaNAF block is rematerialised in the backward pass."""
    for blk in p["naf"]:
        x = RM.checkpoint(naf_block, blk, x) if remat else naf_block(blk, x)
    return RM.checkpoint(ada_naf_v2, p["ada"], x) if remat else ada_naf_v2(p["ada"], x)


def cfrm_init(ini, channels=(128, 256, 512), depths=(1, 1, 9)):
    return [cfrm_stage_init(ini, c, d) for c, d in zip(channels, depths)]
