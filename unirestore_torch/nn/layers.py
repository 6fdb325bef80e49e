"""Core functional layers over dicts of tensors (mirrors ``unirestore_tpu/nn/layers.py``).

Every layer is ``<name>_init(ini, ...) -> params`` and ``<name>(params, x, ...)``.
Feature maps are NHWC at every public function, as in the JAX package.
Convolutions hand ``F.conv2d`` an NCHW *view* of the NHWC tensor: its memory
is ``channels_last``, which cuDNN consumes and produces directly, so the
permutes on either side move no data on the card.

Numerics follow the JAX functions: exact (erf) GELU, and GroupNorm/LayerNorm
with fp32 statistics computed as E[x^2] - E[x]^2 and folded into a
per-channel scale/shift applied in the input dtype.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import init as winit

# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------


def silu(x):
    return F.silu(x)


def gelu(x):
    """Exact (erf) GELU, as JAX ``gelu(approximate=False)``."""
    return F.gelu(x)


def simple_gate(x):
    """NAFNet SimpleGate over the channel (last) axis (JAX ``simple_gate``)."""
    x1, x2 = x.chunk(2, dim=-1)
    return x1 * x2


# ---------------------------------------------------------------------------
# conv2d
# ---------------------------------------------------------------------------


def conv2d_init(ini, cin, cout, kernel_size=3, groups: int = 1, bias: bool = True):
    kh, kw = (kernel_size, kernel_size) if isinstance(kernel_size, int) else kernel_size
    p = {"w": winit.conv_kernel(ini, kh, kw, cin, cout, groups)}
    if bias:
        p["b"] = winit.conv_bias(ini, cout, kh * kw * (cin // groups))
    return p


def conv2d(p, x, stride: int | tuple = 1, padding="SAME", groups: int = 1,
           dilation: int = 1):
    """2D convolution, NHWC x OIHW -> NHWC (JAX ``conv2d``).

    ``padding`` may be "SAME" (stride 1), "VALID", an int (symmetric), or
    explicit ``((top, bottom), (left, right))``.
    """
    w = p["w"].to(x.dtype)
    b = p["b"].to(x.dtype) if "b" in p else None
    if isinstance(padding, str):
        padding = padding.lower()
    elif not isinstance(padding, int):
        (top, bottom), (left, right) = padding
        if top == bottom and left == right:
            padding = (top, left)
        else:
            x = F.pad(x, (0, 0, left, right, top, bottom))
            padding = 0
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride, padding, dilation, groups)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# linear
# ---------------------------------------------------------------------------


def linear_init(ini, cin, cout, bias: bool = True):
    p = {"w": winit.linear_kernel(ini, cin, cout)}
    if bias:
        p["b"] = winit.conv_bias(ini, cout, cin)
    return p


def linear(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


def norm_init(ini, c):
    return {"scale": ini.ones((c,)), "bias": ini.zeros((c,))}


def _stat_dtype(dtype):
    return torch.promote_types(torch.float32, dtype)


def group_norm(p, x, groups: int = 32, eps: float = 1e-5):
    """GroupNorm over NHWC: stats over (H, W, C//G) per group (JAX ``group_norm``).

    Variance is E[x^2] - E[x]^2 in fp32, as the JAX function computes it;
    the normalisation folds into a per-(batch, channel) scale/shift applied
    in the input dtype.
    """
    b, h, w, c = x.shape
    sdt = _stat_dtype(x.dtype)
    xg = x.reshape(b, h * w, groups, c // groups)
    mean = xg.mean(dim=(1, 3), dtype=sdt)  # (b, g)
    mean2 = xg.to(sdt).square().mean(dim=(1, 3))
    inv = torch.rsqrt(mean2 - mean.square() + eps)
    inv_c = inv.repeat_interleave(c // groups, dim=1)  # (b, c)
    mean_c = mean.repeat_interleave(c // groups, dim=1)
    scale = inv_c
    shift = -mean_c * inv_c
    if p is not None:
        g = p["scale"].to(sdt)
        scale = scale * g
        shift = shift * g + p["bias"].to(sdt)
    scale = scale[:, None, None, :].to(x.dtype)
    shift = shift[:, None, None, :].to(x.dtype)
    return x * scale + shift


def layer_norm(p, x, eps: float = 1e-5):
    """LayerNorm over the last axis with fp32 E[x^2] - E[x]^2 (JAX ``layer_norm``)."""
    sdt = _stat_dtype(x.dtype)
    mean = x.mean(dim=-1, keepdim=True, dtype=sdt)
    mean2 = x.to(sdt).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(mean2 - mean.square() + eps)
    y = x * inv.to(x.dtype) + (-mean * inv).to(x.dtype)
    if p is not None:
        y = y * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)
    return y


def instance_norm(x, eps: float = 1e-5):
    """InstanceNorm2d without affine over NHWC (JAX ``instance_norm``)."""
    xf = x.to(_stat_dtype(x.dtype))
    mean = xf.mean(dim=(1, 2), keepdim=True)
    var = xf.var(dim=(1, 2), keepdim=True, correction=0)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


# ---------------------------------------------------------------------------
# pooling / resize primitives
# ---------------------------------------------------------------------------


def global_avg_pool(x, keepdims: bool = True):
    """AdaptiveAvgPool2d(1) over NHWC."""
    return x.mean(dim=(1, 2), keepdim=keepdims)


def upsample_nearest_2x(x):
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return x.reshape(b, 2 * h, 2 * w, c)


_NEAREST_INDEX: dict = {}


def _nearest_index(in_size: int, out_size: int, device):
    """floor(i * (in / out)) for i < out, the product in fp32 as the JAX
    function computes it; made once per (sizes, device), so that a resize
    copies nothing from the host after its first call (a normal tensor even
    under ``inference_mode``, so that autograd may save it)."""
    key = (in_size, out_size, str(device))
    if key not in _NEAREST_INDEX:
        src = np.floor(np.arange(out_size, dtype=np.float32) * np.float32(in_size / out_size))
        with torch.inference_mode(False):
            _NEAREST_INDEX[key] = torch.as_tensor(src.astype(np.int64), device=device)
    return _NEAREST_INDEX[key]


def resize_nearest(x, size: tuple[int, int]):
    """Nearest-neighbour NHWC resize (JAX ``resize_nearest``,
    ``unirestore_tpu/nn/layers.py:186-192``): output row i reads row
    floor(i * (h / oh)), with the product in fp32. At ratios such as 17 -> 33
    this is JAX's mapping, which ``F.interpolate(mode="nearest")`` need not
    reproduce."""
    _, h, w, _ = x.shape
    oh, ow = size
    if (h, w) == (oh, ow):
        return x
    rows = _nearest_index(h, oh, x.device)
    cols = _nearest_index(w, ow, x.device)
    return x.index_select(1, rows).index_select(2, cols)


def pixel_shuffle(x, factor: int = 2):
    """nn.PixelShuffle for NHWC: (B,H,W,C*r^2) -> (B,H*r,W*r,C), NCHW channel order."""
    b, h, w, crr = x.shape
    r = factor
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)
