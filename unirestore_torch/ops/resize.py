"""Image resize and pad over NHWC (mirrors ``unirestore_tpu/ops/resize.py``).

``resize_bicubic`` and ``resize_bilinear`` are torch's bicubic (Keys a =
-0.75) and bilinear interpolation (``align_corners=False``, edge clamp, no
antialias) written as the JAX functions write them: four- or two-tap gathers
along each axis with source positions and weights computed in float64 on the
host, the taps summed in fp32. ``F.interpolate`` computes the positions in
fp32, which at a 512 -> 224 px shrink puts its output 3.7e-5 (bilinear, the
critics' preprocessing) and 2.4e-4 after CLIP's normalisation (bicubic,
CLIP-IQA's preprocessing) from the exact positions' (and the JAX
functions'). Neither antialiases when it shrinks. ``resize_bilinear_ac`` is
the bilinear gather at ``align_corners=True`` positions (the RefineNet-LW
top-down upsampling).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _cubic_weights(frac: np.ndarray, a: float = -0.75) -> np.ndarray:
    """(out, 4) cubic convolution weights of the taps at offsets -1, 0, 1, 2."""
    d = np.abs(np.stack([frac + 1.0, frac, 1.0 - frac, 2.0 - frac], axis=-1))
    return np.where(d <= 1.0, (a + 2.0) * d ** 3 - (a + 3.0) * d ** 2 + 1.0,
                    np.where(d < 2.0, a * d ** 3 - 5.0 * a * d ** 2 + 8.0 * a * d - 4.0 * a, 0.0))


_TAPS: dict = {}


def _taps(in_size: int, out_size: int, device, kind: str = "linear",
          align_corners: bool = False) -> tuple:
    """((index, weight), ...) of the two (linear) or four (cubic) taps, made once
    per (sizes, device, kind, convention) so that a resize copies nothing from
    the host after its first call; normal tensors even under ``inference_mode``,
    so that autograd may save them."""
    key = (in_size, out_size, str(device), kind, align_corners)
    if key not in _TAPS:
        if align_corners:
            pos = np.arange(out_size, dtype=np.float64) * ((in_size - 1) / max(out_size - 1, 1))
        else:
            pos = (np.arange(out_size, dtype=np.float64) + 0.5) * (in_size / out_size) - 0.5
        base = np.floor(pos).astype(np.int64)
        frac = pos - base
        if kind == "cubic":
            offsets, weights = (-1, 0, 1, 2), _cubic_weights(frac).T
        else:
            offsets, weights = (0, 1), (1.0 - frac, frac)
        with torch.inference_mode(False):
            _TAPS[key] = tuple(
                (torch.as_tensor(np.clip(base + tap, 0, in_size - 1), device=device),
                 torch.as_tensor(w.astype(np.float32), device=device))
                for tap, w in zip(offsets, weights))
    return _TAPS[key]


def _resize_axis(x, out_size: int, axis: int, kind: str = "linear",
                 align_corners: bool = False):
    """Interpolation along ``axis`` to ``out_size`` (half-pixel centres or
    aligned corners, edge clamp), the taps summed in fp32."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    shape = [1] * x.ndim
    shape[axis] = out_size
    out = 0
    for idx, w in _taps(in_size, out_size, x.device, kind, align_corners):
        out = out + x.index_select(axis, idx).float() * w.reshape(shape)
    return out.to(x.dtype)


def resize_bicubic(x, size: tuple[int, int]):
    """Bicubic NHWC resize = torch interpolate(mode="bicubic", align_corners=False,
    antialias=False), positions in float64 (``unirestore_tpu/ops/resize.py:74-83``);
    the output is not range-clamped."""
    return _resize_axis(_resize_axis(x, size[0], 1, "cubic"), size[1], 2, "cubic")


def resize_bilinear(x, size: tuple[int, int]):
    """Bilinear NHWC resize = torch interpolate(mode="bilinear", align_corners=False,
    antialias=False), positions in float64 (``unirestore_tpu/ops/resize.py:82-88``)."""
    return _resize_axis(_resize_axis(x, size[0], 1), size[1], 2)


def resize_bilinear_ac(x, size: tuple[int, int]):
    """Bilinear NHWC resize = torch interpolate(mode="bilinear", align_corners=True),
    positions in float64 (``unirestore_tpu/ops/resize.py:91-99``)."""
    return _resize_axis(_resize_axis(x, size[0], 1, "linear", True), size[1], 2, "linear", True)


def reflect_pad_hw(x, pad_h: int, pad_w: int):
    """Reflect-pad bottom/right by (pad_h, pad_w)."""
    if pad_h == 0 and pad_w == 0:
        return x
    y = F.pad(x.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h), mode="reflect")
    return y.permute(0, 2, 3, 1)
