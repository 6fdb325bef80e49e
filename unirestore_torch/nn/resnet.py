"""Stable-Diffusion ResNet blocks and up/down samplers over NHWC maps.

Mirrors ``unirestore_tpu/nn/resnet.py`` (diffusers ``ResnetBlock2D`` /
``Downsample2D`` / ``Upsample2D``).
"""

from __future__ import annotations

from . import layers as L


def resnet_block_init(ini, cin: int, cout: int, temb_dim: int | None = None):
    p = {
        "norm1": L.norm_init(ini, cin),
        "conv1": L.conv2d_init(ini, cin, cout, 3),
        "norm2": L.norm_init(ini, cout),
        "conv2": L.conv2d_init(ini, cout, cout, 3),
    }
    if temb_dim is not None:
        p["time_emb_proj"] = L.linear_init(ini, temb_dim, cout)
    if cin != cout:
        p["conv_shortcut"] = L.conv2d_init(ini, cin, cout, 1)
    return p


def resnet_block(p, x, temb=None, groups: int = 32, eps: float = 1e-5, modulate=None):
    """norm1 -> silu -> conv1 -> (+temb) -> norm2 -> silu -> conv2 -> +shortcut;
    ``modulate``, if given, maps the conv2 output before the add (the UNet's
    SPADE control)."""
    h = L.silu(L.group_norm(p["norm1"], x, groups=groups, eps=eps))
    h = L.conv2d(p["conv1"], h, padding=1)
    if temb is not None and "time_emb_proj" in p:
        t = L.linear(p["time_emb_proj"], L.silu(temb))
        h = h + t[:, None, None, :].to(h.dtype)
    h = L.silu(L.group_norm(p["norm2"], h, groups=groups, eps=eps))
    h = L.conv2d(p["conv2"], h, padding=1)
    if modulate is not None:
        h = modulate(h)
    if "conv_shortcut" in p:
        x = L.conv2d(p["conv_shortcut"], x, padding=0)
    return x + h


def downsample_init(ini, channels: int):
    return {"conv": L.conv2d_init(ini, channels, channels, 3)}


def downsample(p, x, pad_mode: str = "sym"):
    """Stride-2 3x3 conv. ``pad_mode``: "sym" (UNet, padding=1) or
    "asym" (VAE encoder, zero-pad bottom/right by one, then VALID). Output row
    i reads input rows 2i - 1 .. 2i + 1 ("sym") or 2i .. 2i + 2 ("asym"): on
    a height-sharded slab ``L.conv2d`` fetches the row above or below."""
    if pad_mode == "asym":
        return L.conv2d(p["conv"], x, stride=2, padding=((0, 1), (0, 1)))
    return L.conv2d(p["conv"], x, stride=2, padding=1)


def upsample_init(ini, channels: int):
    return {"conv": L.conv2d_init(ini, channels, channels, 3)}


def upsample(p, x):
    """Nearest 2x then 3x3 conv (diffusers Upsample2D with use_conv)."""
    return L.conv2d(p["conv"], L.upsample_nearest_2x(x), padding=1)
