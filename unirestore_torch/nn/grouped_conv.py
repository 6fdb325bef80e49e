"""The CFRM AdaNAFV2 grouped 3x3 convolution: kernel, plain version, gradient.

Replaces the Pallas TPU kernel of ``unirestore_tpu/nn/pallas_grouped_conv.py``
(``_kernel`` v2 and ``_kernel_v3``, entry ``grouped_conv3_pallas``): a
SAME-padded, stride-1, 3x3 grouped conv of an NHWC map, cin == cout. Two
hand-written CUDA C++ sources for ``sm_90a``, each an implicit GEMM per group
that adds the bias before its one rounding to the input type; each source
says what bounds it on the H100:

- ``csrc/grouped_conv_sm90.cu``: ``ur_grouped_conv3_sm90``, every bf16 launch
  (``wgmma``, halo tiles by TMA with zero-fill padding, 64 output channels
  per persistent block with their weights resident in shared memory);
- ``csrc/grouped_conv.cu``: ``ur_grouped_conv3``, every fp32 launch (CUDA-core
  FMAs). Its bf16 body (``mma.sync``), which the Hopper kernel replaced, stays
  as a yardstick and is never routed.

Weights are the port's OIHW ``(C, C // groups, 3, 3)``; the wrapper packs them
per group and tap as ``(groups, 9, cg_out, cg_in)`` for the kernel.

``grouped_conv3`` applies ``GroupedConv3Function``: the forward is the kernel
for CUDA tensors and the plain version for CPU tensors; the backward is the
VJP of the grouped conv through PyTorch's own conv gradients
(``torch.nn.grad.conv2d_input`` / ``conv2d_weight``), as the JAX custom VJP's
backward (pallas_grouped_conv.py:201-205) is XLA's conv.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
import torch.nn.functional as F

from . import cuda_lib

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "grouped_conv.cu"
SOURCE_SM90 = SOURCE.with_name("grouped_conv_sm90.cu")
# ur_grouped_conv3_sm90's output tiles and the channels of its TMA boxes
# (one 128-byte swizzle row); its tensor maps view x and y as (C, W, H, B)
# with boxes of SM90_BOX_C channels over a halo of (SM90_TILE + 2) pixels
# for x and at most a whole output tile for y
SM90_TILE = (8, 16)  # output rows, columns per tile
SM90_BOX_C = 64
GROUP_WIDTHS = (16, 32, 64, 128)  # per-group channels the kernel is built for


def supported(x_shape, w_shape, groups: int) -> bool:
    """Shapes the CUDA kernel takes: x NHWC (B, H, W, C), w OIHW (C, C/groups, 3, 3).

    Any B, H, W (ragged tile edges are masked); C/groups one of ``GROUP_WIDTHS``.
    """
    b, h, w, c = x_shape
    cout, cg, kh, kw = w_shape
    return (kh == 3 and kw == 3 and cout == c and groups > 0 and cg * groups == c
            and cg in GROUP_WIDTHS and min(b, h, w) > 0)


def grouped_conv3_plain(x, w, b=None, groups: int = 16):
    """Per group and per tap, a product with fp32 accumulation; bias in fp32; one
    rounding to x's dtype. x NHWC, w OIHW; independent of cuDNN."""
    bsz, h, wd, c = x.shape
    cg = c // groups
    xg = F.pad(x.float(), (0, 0, 1, 1, 1, 1)).reshape(bsz, h + 2, wd + 2, groups, cg)
    wg = w.float().reshape(groups, cg, cg, 3, 3)  # (g, out, in, ky, kx)
    acc = torch.zeros((bsz, h, wd, groups, cg), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            acc += torch.einsum("bhwgi,goi->bhwgo", xg[:, dy:dy + h, dx:dx + wd],
                                wg[..., dy, dx])
    if b is not None:
        acc += b.float().reshape(groups, cg)
    return acc.reshape(bsz, h, wd, c).to(x.dtype)


# A bf16 kernel output agrees with its plain version ``ref`` when, elementwise,
#     |out - ref| <= RTOL * |ref| + ATOL_RMS * rms(ref).
# Both multiply bf16 values exactly and sum in fp32 (another order), then round
# once: the fp32 sums differ by about sqrt(9 cg) * 2^-24 of the terms' size,
# some 1e-5 rms(ref), so the rounded outputs differ by at most one bf16 ulp,
# which is at most 2^-7 |ref| and reaches it where ref sits on a power of two.
# RTOL allows two ulps, so such a flip reads half the limit; the absolute term,
# 2^-10 rms(ref), covers the fp32 difference near zero. A dropped tap or a halo
# row read one row off moves outputs by about a third of rms(ref) and fails by
# two orders of magnitude.
RTOL = 2.0 ** -6
ATOL_RMS = 2.0 ** -10


def bf16_tolerance_ratio(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| / (RTOL |ref| + ATOL_RMS rms(ref)); at most 1 to agree."""
    return cuda_lib.tolerance_ratio(out, ref, RTOL, ATOL_RMS)


def _load(source: Path, symbol: str) -> ctypes.CDLL:
    """The library of ``source`` with C entry ``symbol`` (x, w, bias, y, six
    ints, stream), built unless a library of the same source hash exists."""
    lib = ctypes.CDLL(str(cuda_lib.build_all([source])[0]))
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """``csrc/grouped_conv.cu`` (``ur_grouped_conv3``)."""
    return _load(SOURCE, "ur_grouped_conv3")


@functools.cache
def library_sm90() -> ctypes.CDLL:
    """``csrc/grouped_conv_sm90.cu`` (``ur_grouped_conv3_sm90``)."""
    return _load(SOURCE_SM90, "ur_grouped_conv3_sm90")


def pack_weights(w, groups: int):
    """OIHW (C, cg, 3, 3) -> (groups, 9, cg_out, cg_in), contiguous."""
    c, cg = w.shape[:2]
    return w.reshape(groups, cg, cg, 9).permute(0, 3, 1, 2).contiguous()


class GroupedConv3Function(torch.autograd.Function):
    """Kernel (CUDA) or plain (CPU) forward; grouped-conv VJP backward."""

    @staticmethod
    def forward(ctx, kern, x, w, b, groups):
        ctx.kern, ctx.groups = kern, groups
        ctx.save_for_backward(x, w)
        return kern.forward(x, w, b, groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        ctx.kern.backwards += 1
        need_x, need_w, need_b = ctx.needs_input_grad[1:4]
        xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)  # NCHW views
        gx = gw = gb = None
        if need_x:
            gx = torch.nn.grad.conv2d_input(xc.shape, w, gc, padding=1,
                                            groups=ctx.groups).permute(0, 2, 3, 1)
        if need_w:
            gw = torch.nn.grad.conv2d_weight(xc, w.shape, gc, padding=1, groups=ctx.groups)
        if need_b:  # False when b is None
            gb = g.float().sum(dim=(0, 1, 2)).to(g.dtype)
        return None, gx, gw, gb, None


class GroupedConvKernel(cuda_lib.KernelWrapper):
    """``grouped_conv3(x, w, b=None, groups=16)``: the kernel entries with
    their gradient; bf16 launches take ``ur_grouped_conv3_sm90``, fp32 ones
    ``ur_grouped_conv3``."""

    symbol = "ur_grouped_conv3"
    replaces = "unirestore_tpu/nn/pallas_grouped_conv.py:80"
    base = (library, SOURCE)
    symbols = {torch.bfloat16: ("ur_grouped_conv3_sm90", library_sm90, SOURCE_SM90)}
    plain = staticmethod(grouped_conv3_plain)

    def __call__(self, x, w, b=None, groups: int = 16):
        return GroupedConv3Function.apply(self, x, w, b, groups)

    def forward(self, x, w, b=None, groups: int = 16):
        tensors = (x, w) if b is None else (x, w, b)
        devices = {t.device.type for t in tensors}
        if devices == {"cpu"}:
            return self.plain(x, w, b, groups)
        if devices != {"cuda"} or len({t.device for t in tensors}) != 1:
            raise ValueError(f"{self.symbol}: x, w, b must lie on one CUDA device, "
                             f"got {[str(t.device) for t in tensors]}")
        if x.dtype not in cuda_lib.DTYPE_CODES or any(t.dtype != x.dtype for t in tensors):
            raise TypeError(f"{self.symbol}: dtypes {[t.dtype for t in tensors]}; "
                            "want all float32 or all bfloat16")
        if x.dim() != 4 or w.dim() != 4 or not supported(x.shape, w.shape, groups):
            raise ValueError(f"{self.symbol}: unsupported shapes x {tuple(x.shape)}, "
                             f"w {tuple(w.shape)}, groups {groups}")
        if b is not None and tuple(b.shape) != (x.shape[-1],):
            raise ValueError(f"{self.symbol}: bias shape {tuple(b.shape)}")
        x = x.contiguous()
        wp = pack_weights(w, groups)
        if x.data_ptr() % 16 or wp.data_ptr() % 16:
            raise ValueError(f"{self.symbol}: x and w must start on 16-byte boundaries")
        bc = None if b is None else b.contiguous()
        out = torch.empty_like(x)
        bsz, h, wd, c = x.shape
        with torch.cuda.device(x.device):
            symbol, lib = self.route(x.dtype)
            rc = getattr(lib, symbol)(
                x.data_ptr(), wp.data_ptr(), None if bc is None else bc.data_ptr(),
                out.data_ptr(), bsz, h, wd, c, c // groups,
                cuda_lib.DTYPE_CODES[x.dtype], torch.cuda.current_stream().cuda_stream)
        self.counted(rc, symbol, x)
        return out


grouped_conv3 = GroupedConvKernel()
