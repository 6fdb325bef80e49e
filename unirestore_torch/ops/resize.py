"""Image resize and pad over NHWC (mirrors ``unirestore_tpu/ops/resize.py``).

The JAX package reimplements torch's bicubic interpolation (Keys a = -0.75,
half-pixel centres, edge clamp, no antialias); here it is
``F.interpolate(mode="bicubic", align_corners=False)`` itself.

``resize_bilinear`` is torch's bilinear interpolation (``align_corners=False``,
no antialias) written as the JAX function writes it: two-tap gathers along
each axis with source positions and weights computed in float64 on the host.
``F.interpolate(mode="bilinear")`` computes the positions in fp32, which at
the critics' 512 -> 224 px shrink puts its output 3.7e-5 from the exact
positions' (and the JAX function's). Neither antialiases when it shrinks.
``resize_bilinear_ac`` is the same gather at ``align_corners=True`` positions
(the RefineNet-LW top-down upsampling).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def resize_bicubic(x, size: tuple[int, int]):
    """Bicubic NHWC resize; the output is not range-clamped."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bicubic",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


_LINEAR_TAPS: dict = {}


def _linear_taps(in_size: int, out_size: int, device, align_corners: bool = False) -> tuple:
    """((index, weight), (index, weight)) of the two taps, made once per
    (sizes, device, convention) so that a resize copies nothing from the host after
    its first call; normal tensors even under ``inference_mode``, so that autograd
    may save them."""
    key = (in_size, out_size, str(device), align_corners)
    if key not in _LINEAR_TAPS:
        if align_corners:
            pos = np.arange(out_size, dtype=np.float64) * ((in_size - 1) / max(out_size - 1, 1))
        else:
            pos = (np.arange(out_size, dtype=np.float64) + 0.5) * (in_size / out_size) - 0.5
        base = np.floor(pos).astype(np.int64)
        frac = pos - base
        with torch.inference_mode(False):
            _LINEAR_TAPS[key] = tuple(
                (torch.as_tensor(np.clip(base + tap, 0, in_size - 1), device=device),
                 torch.as_tensor(w.astype(np.float32), device=device))
                for tap, w in ((0, 1.0 - frac), (1, frac)))
    return _LINEAR_TAPS[key]


def _linear_axis(x, out_size: int, axis: int, align_corners: bool = False):
    """Linear interpolation along ``axis`` to ``out_size`` (half-pixel centres or
    aligned corners, edge clamp)."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    shape = [1] * x.ndim
    shape[axis] = out_size
    out = 0
    for idx, w in _linear_taps(in_size, out_size, x.device, align_corners):
        out = out + x.index_select(axis, idx).float() * w.reshape(shape)
    return out.to(x.dtype)


def resize_bilinear(x, size: tuple[int, int]):
    """Bilinear NHWC resize = torch interpolate(mode="bilinear", align_corners=False,
    antialias=False), positions in float64 (``unirestore_tpu/ops/resize.py:82-88``)."""
    return _linear_axis(_linear_axis(x, size[0], 1), size[1], 2)


def resize_bilinear_ac(x, size: tuple[int, int]):
    """Bilinear NHWC resize = torch interpolate(mode="bilinear", align_corners=True),
    positions in float64 (``unirestore_tpu/ops/resize.py:91-99``)."""
    return _linear_axis(_linear_axis(x, size[0], 1, True), size[1], 2, True)


def reflect_pad_hw(x, pad_h: int, pad_w: int):
    """Reflect-pad bottom/right by (pad_h, pad_w)."""
    if pad_h == 0 and pad_w == 0:
        return x
    y = F.pad(x.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h), mode="reflect")
    return y.permute(0, 2, 3, 1)
