"""Transformer2DModel for the SD2.1 UNet (mirrors ``unirestore_tpu/nn/transformer.py``).

GroupNorm -> linear proj_in -> BasicTransformerBlock(s) (self-attention,
cross-attention on the text context, GEGLU feed-forward) -> linear proj_out
-> residual, over NHWC maps.
"""

from __future__ import annotations

from . import attention as A
from . import layers as L


def basic_transformer_block_init(ini, dim: int, heads: int, dim_head: int,
                                 context_dim: int):
    return {
        "norm1": L.norm_init(ini, dim),
        "attn1": A.mha_init(ini, dim, heads, dim_head),
        "norm2": L.norm_init(ini, dim),
        "attn2": A.mha_init(ini, dim, heads, dim_head, context_dim=context_dim),
        "norm3": L.norm_init(ini, dim),
        "ff_in": L.linear_init(ini, dim, dim * 8),   # GEGLU proj
        "ff_out": L.linear_init(ini, dim * 4, dim),
    }


def basic_transformer_block(p, x, context, heads: int):
    x = x + A.mha(p["attn1"], L.layer_norm(p["norm1"], x), heads=heads)
    x = x + A.mha(p["attn2"], L.layer_norm(p["norm2"], x), context=context, heads=heads)
    h = L.linear(p["ff_in"], L.layer_norm(p["norm3"], x))
    val, gate = h.chunk(2, dim=-1)
    return x + L.linear(p["ff_out"], val * L.gelu(gate))


def transformer_2d_init(ini, channels: int, heads: int, context_dim: int,
                        depth: int = 1):
    dim_head = channels // heads
    return {
        "norm": L.norm_init(ini, channels),
        "proj_in": L.linear_init(ini, channels, channels),
        "blocks": [basic_transformer_block_init(ini, channels, heads, dim_head, context_dim)
                   for _ in range(depth)],
        "proj_out": L.linear_init(ini, channels, channels),
    }


def transformer_2d(p, x, context, heads: int, groups: int = 32, eps: float = 1e-6):
    """Spatial transformer over an NHWC map with (B, S, Cctx) text context."""
    b, h, w, c = x.shape
    y = L.group_norm(p["norm"], x, groups=groups, eps=eps).reshape(b, h * w, c)
    y = L.linear(p["proj_in"], y)
    for blk in p["blocks"]:
        y = basic_transformer_block(blk, y, context, heads)
    y = L.linear(p["proj_out"], y)
    return x + y.reshape(b, h, w, c)
