"""Image resize and pad over NHWC (mirrors ``unirestore_tpu/ops/resize.py``).

The JAX package reimplements torch's bicubic interpolation (Keys a = -0.75,
half-pixel centres, edge clamp, no antialias); here it is
``F.interpolate(mode="bicubic", align_corners=False)`` itself.
"""

from __future__ import annotations

import torch.nn.functional as F


def resize_bicubic(x, size: tuple[int, int]):
    """Bicubic NHWC resize; the output is not range-clamped."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bicubic",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def reflect_pad_hw(x, pad_h: int, pad_w: int):
    """Reflect-pad bottom/right by (pad_h, pad_w)."""
    if pad_h == 0 and pad_w == 0:
        return x
    y = F.pad(x.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h), mode="reflect")
    return y.permute(0, 2, 3, 1)
