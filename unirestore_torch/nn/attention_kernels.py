"""The three attention kernels of the restore path, each beside its plain version.

Replaces the Pallas TPU kernels of ``unirestore_tpu/nn/pallas_attention.py``
that the restore path launches:

==============================================  ===================================
wrapper (this module)                           TPU kernel it replaces
==============================================  ===================================
``fused_attention_btc_prescaled``               ``_btc_kernel`` (via ``_fused_raw_btc``)
``fused_attention_bh_prescaled``                ``_kernel`` (via ``_fused_raw_bh``)
``streaming_attention_bh_prescaled``            ``_stream_kernel`` (via ``_streaming_raw_bh``)
==============================================  ===================================

Each computes ``softmax_2(q k^T) v`` for q prescaled by d^-1/2 * log2(e):
exp2, fp32 logits and statistics, probabilities rounded to v's dtype before
the PV product, output divided by the row sum. The kernels are hand-written
CUDA C++ for ``sm_90a`` in ``unirestore_torch/csrc/attention.cu``: bf16 on the
tensor cores (``mma.sync``), fp32 on CUDA-core FMAs (the source says what
bounds them on the H100 and what the design does about it). They are
compiled with ``nvcc`` at first use into ``unirestore_torch/_build/`` (rebuilt
when the source's content hash changes) and bound with ``ctypes``.

A wrapper given CPU tensors computes the plain PyTorch version (the CPU tests
use it); given CUDA tensors it launches its kernel on the current stream or
raises. It never falls back. Each wrapper counts its launches in
``.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import subprocess
from pathlib import Path

import torch

LOG2E = 1.4426950408889634

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "attention.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# ---------------------------------------------------------------------------
# routing predicates (copies of pallas_attention.py's, by shape alone)
# ---------------------------------------------------------------------------


def supported(t: int, s: int, d: int) -> bool:
    """Head-major kernel shapes (JAX ``supported``)."""
    return t == s and t >= 256 and t % 8 == 0 and d % 64 == 0 and d <= 128


def btc_supported(t: int, s: int, inner: int, dim_head: int) -> bool:
    """Channel-flat kernel shapes (JAX ``btc_supported``): T >= 1024, 64-d heads."""
    return (t == s and t >= 1024 and t % 256 == 0
            and dim_head == 64 and inner % 64 == 0)


def stream_supported(t: int, s: int, d: int) -> bool:
    """Wide-head streaming kernel shapes (JAX ``stream_supported``)."""
    return (t == s and t >= 1024 and t % 1024 == 0 and 128 < d <= 512
            and d % 128 == 0)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def attention_bh_plain(q, k, v):
    """softmax_2(q k^T) v over (N, T, D) with fp32 logits and statistics."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return (o / l).to(q.dtype)


def attention_btc_plain(q, k, v):
    """``attention_bh_plain`` per 64-wide head window of (B, T, H*64) tensors."""
    b, t, inner = q.shape

    def heads(x):
        return x.reshape(b, t, inner // 64, 64).transpose(1, 2)

    o = attention_bh_plain(heads(q), heads(k), heads(v))
    return o.transpose(1, 2).reshape(b, t, inner)


# A bf16 kernel output agrees with its plain version ``ref`` when, elementwise,
#     |out - ref| <= BF16_RTOL * |ref| + BF16_ATOL_RMS * rms(ref).
# Before their last rounding to bf16 the two differ only by the rounding of
# each probability to bf16 against another running maximum (2^-9 relative,
# averaging out over the keys) and by fp32 summation order, far below one bf16
# ulp of the output. Two such values round at most one ulp apart, and one ulp
# is at most 2^-7 |ref|; the absolute term covers outputs near zero. It scales
# with rms(ref), which falls as 1/sqrt(T) for diffuse attention, so a kernel
# that drops one 64-key tile at T=4096 (errors about 0.1 rms(ref)) still fails.
BF16_RTOL = 2.0 ** -7
BF16_ATOL_RMS = 0.03


def bf16_tolerance_ratio(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| / (BF16_RTOL |ref| + BF16_ATOL_RMS rms(ref)); at most 1 to agree."""
    out, ref = out.float(), ref.float()
    limit = BF16_RTOL * ref.abs() + BF16_ATOL_RMS * ref.square().mean().sqrt()
    ratio = ((out - ref).abs() / limit).max().item()
    return ratio if math.isfinite(ratio) else math.inf  # NaN anywhere disagrees


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> Path:
    """Compile ``csrc/attention.cu`` unless a library of the same source hash exists.

    Returns the shared library's path; ``nvcc``'s output (with ``-Xptxas -v``'s
    register and shared-memory report) is kept beside it as ``.log``.
    """
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"attention-{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = BUILD_DIR / f"attention-{tag}.{os.getpid()}.tmp"
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    lib.with_suffix(".log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name in ("ur_attention_btc", "ur_attention_bh", "ur_attention_stream"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


class AttentionKernel:
    """One kernel entry: plain version on the CPU, the CUDA kernel on the card.

    ``dims(q)`` checks the shape against the kernel's predicate and returns the
    three int arguments of the C entry ``symbol``; ``replaces`` is the TPU
    kernel's file:line.
    """

    def __init__(self, symbol: str, plain, dims, replaces: str):
        self.symbol = symbol
        self.plain = plain
        self.dims = dims
        self.replaces = replaces
        self.launches = 0

    def __call__(self, q, k, v):
        devices = {q.device.type, k.device.type, v.device.type}
        if devices == {"cpu"}:
            return self.plain(q, k, v)
        if devices != {"cuda"} or len({q.device, k.device, v.device}) != 1:
            raise ValueError(f"{self.symbol}: q, k, v must lie on one CUDA device, "
                             f"got {q.device}, {k.device}, {v.device}")
        if q.dtype not in _DTYPE_CODES or not q.dtype == k.dtype == v.dtype:
            raise TypeError(f"{self.symbol}: dtypes {q.dtype}, {k.dtype}, {v.dtype}; "
                            "want all float32 or all bfloat16")
        if not q.shape == k.shape == v.shape:
            raise ValueError(f"{self.symbol}: shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                             f"{tuple(v.shape)} differ")
        if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
            raise ValueError(f"{self.symbol}: q, k, v must be contiguous")
        if any(x.data_ptr() % 16 for x in (q, k, v)):
            raise ValueError(f"{self.symbol}: q, k, v must start on 16-byte boundaries")
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            raise RuntimeError(f"{self.symbol}: forward-only kernel; inputs require grad")
        dims = self.dims(q)
        out = torch.empty_like(q)
        with torch.cuda.device(q.device):
            rc = getattr(library(), self.symbol)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *dims,
                _DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {rc}")
        self.launches += 1
        return out


def _btc_dims(q):
    if q.dim() != 3 or not btc_supported(q.shape[1], q.shape[1], q.shape[2], 64):
        raise ValueError(f"channel-flat attention: unsupported shape {tuple(q.shape)}")
    return q.shape[0], q.shape[1], q.shape[2]


def _bh_dims(q):
    if q.dim() != 3 or not supported(q.shape[1], q.shape[1], q.shape[2]):
        raise ValueError(f"head-major attention: unsupported shape {tuple(q.shape)}")
    return q.shape[0], q.shape[1], q.shape[2]


def _stream_dims(q):
    if q.dim() != 3 or not stream_supported(q.shape[1], q.shape[1], q.shape[2]):
        raise ValueError(f"streaming attention: unsupported shape {tuple(q.shape)}")
    return q.shape[0], q.shape[1], q.shape[2]


fused_attention_btc_prescaled = AttentionKernel(
    "ur_attention_btc", attention_btc_plain, _btc_dims,
    "unirestore_tpu/nn/pallas_attention.py:220")
fused_attention_bh_prescaled = AttentionKernel(
    "ur_attention_bh", attention_bh_plain, _bh_dims,
    "unirestore_tpu/nn/pallas_attention.py:32")
streaming_attention_bh_prescaled = AttentionKernel(
    "ur_attention_stream", attention_bh_plain, _stream_dims,
    "unirestore_tpu/nn/pallas_attention.py:83")

KERNELS = (fused_attention_btc_prescaled, fused_attention_bh_prescaled,
           streaming_attention_bh_prescaled)


def reset_launches() -> None:
    for kern in KERNELS:
        kern.launches = 0
