"""The four attention kernels, each beside its plain version, with gradients.

Replaces the Pallas TPU kernels of ``unirestore_tpu/nn/pallas_attention.py``:

==============================================  ===================================
wrapper (this module)                           TPU kernel it replaces
==============================================  ===================================
``fused_attention_btc_prescaled``               ``_btc_kernel`` (via ``_fused_raw_btc``)
``fused_attention_bh_prescaled``                ``_kernel`` (via ``_fused_raw_bh``)
``streaming_attention_bh_prescaled``            ``_stream_kernel`` (via ``_streaming_raw_bh``)
``fused_attention_btc_out_prescaled``           ``_btc_out_kernel`` (via ``_fused_raw_btc_out``)
==============================================  ===================================

Each computes ``softmax_2(q k^T) v`` for q prescaled by d^-1/2 * log2(e):
exp2, fp32 logits and statistics, probabilities rounded to v's dtype before
the PV product, output divided by the row sum. The fourth then multiplies the
(B, T, inner) result, rounded to q's dtype per head, by the out-projection
weight ``wo`` (inner, C) in fp32 and rounds once (the bias stays with the
caller, as in the JAX package). The kernels are hand-written
CUDA C++ for ``sm_90a`` (each source says what bounds it on the H100 and what
its design does about it), built and bound by ``cuda_lib``:

- ``csrc/attention_sm90.cu``: the bf16 channel-flat kernel
  ``ur_attention_btc_sm90`` (``wgmma`` for both products, K and V brought by
  TMA through a shared-memory ring, 128-query blocks);
- ``csrc/attention_stream_sm90.cu``: the bf16 wide-head kernel
  ``ur_attention_stream_sm90`` (the same, with 64-query blocks whose two
  consumer warpgroups split the output columns and the d-reduction);
- ``csrc/attention_bh_sm90.cu``: the bf16 head-major kernel
  ``ur_attention_bh_sm90`` (64-query blocks of one consumer warpgroup, the
  K/V tiles of a T = 256 row all loaded at block start, masked tails);
- ``csrc/attention_out_sm90.cu``: the bf16 out-projection-fused kernel
  ``ur_attention_btc_out_sm90`` (``ur_attention_btc_sm90``'s body per head,
  the heads of 128 queries split over a thread-block cluster whose CTAs
  read each other's bf16 head outputs from shared memory, the out-projection
  on ``wgmma``);
- ``csrc/attention.cu``: every fp32 launch, on CUDA-core FMAs
  (``ur_attention_btc``, ``ur_attention_bh``, ``ur_attention_stream``,
  ``ur_attention_btc_out``); its bf16 ``mma.sync`` bodies are the yardsticks
  of the kernels that replaced them, never routed.

A wrapper given CPU tensors computes the plain PyTorch version (the CPU tests
use it); given CUDA tensors it launches its kernel on the current stream or
raises. It never falls back.

Gradients: each wrapper is a ``torch.autograd.Function``, the analogue of the
JAX custom VJPs (``_make_diffable_btc`` / ``_make_diffable_bh``,
pallas_attention.py:342-432). The forward is the kernel; the backward
recomputes ``softmax_e(ln2 * q k^T) v`` (= ``softmax_2(q k^T) v``, JAX's
``_xla_reference_*`` at scale ln 2) in plain PyTorch over query chunks
(``train_attn_chunk``, as JAX's ``_train_attn_chunk`` chunks its training
attention) and differentiates it, so only one (chunk, T) slab per head is
live. The fourth's backward multiplies that recompute by ``wo`` and returns a
gradient for ``wo`` too (JAX ``_make_diffable_btc_out``). No TPU kernel has a
backward kernel; neither has the port.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from . import cuda_lib

LOG2E = 1.4426950408889634
LN2 = math.log(2.0)
TRAIN_ATTN_CHUNK = 512

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "attention.cu"
SOURCE_SM90 = SOURCE.with_name("attention_sm90.cu")
# ur_attention_btc_sm90 takes 128-query blocks and 128-key tiles, unmasked:
# every shape ``btc_supported`` admits has T % BTC_SM90_BLOCK == 0 (and
# inner % 64 == 0)
BTC_SM90_BLOCK = 128
SOURCE_STREAM_SM90 = SOURCE.with_name("attention_stream_sm90.cu")
# ur_attention_stream_sm90 takes 64-query blocks and 64-key tiles, unmasked,
# and head widths STREAM_SM90_WIDTHS: every shape ``stream_supported`` admits
# has T % STREAM_SM90_BLOCK == 0 and one of those widths
STREAM_SM90_BLOCK = 64
STREAM_SM90_WIDTHS = (256, 384, 512)
SOURCE_BH_SM90 = SOURCE.with_name("attention_bh_sm90.cu")
# ur_attention_bh_sm90 takes 64-query blocks and 64-key tiles, masking the
# last of each where T is not a multiple of 64, any T >= BH_SM90_MIN_T and
# head widths BH_SM90_WIDTHS: every shape ``supported`` admits qualifies
BH_SM90_BLOCK = 64
BH_SM90_MIN_T = 64
BH_SM90_WIDTHS = (64, 128)
SOURCE_OUT_SM90 = SOURCE.with_name("attention_out_sm90.cu")

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


def btc_out_supported(c_out: int) -> bool:
    """Out-projection widths the fused kernel takes (JAX ``_use_btc_fused_out``'s
    shape test, attention.py:125-126), on top of ``btc_supported``."""
    return c_out % 128 == 0 or c_out in (320, 640)


# The fused kernel's (64, inner) bf16 tile of per-head outputs must fit the
# card's 227 KB of shared memory beside the q/k/v tiles (csrc/attention.cu).
BTC_OUT_MAX_INNER = 1536

# ur_attention_btc_out_sm90 (csrc/attention_out_sm90.cu) runs a thread-block
# cluster of G CTAs per (batch, 128 queries): CTA r attends to heads r, r + G,
# ... and computes one share of the 64-column chunks of the output from every
# head. These copy its host rules (``cluster_size``, ``chunk_group``,
# ``smem_bytes``), so that the tests can hold every routed shape to them; an
# edit of one needs the same edit of the other.
BTC_OUT_SM90_BLOCK = 128
BTC_OUT_SM90_MAX_CLUSTER = 8  # the portable cluster size
BTC_OUT_SM90_MAX_CHUNKS = 3  # output chunks of 64 columns an epilogue pass takes
BTC_OUT_SM90_MAX_SMEM = 232448  # the H100's opt-in limit per block, bytes


def btc_out_sm90_cluster(heads: int, blocks: int, sms: int) -> int:
    """G for ``heads`` heads over ``blocks`` = B * T / 128 query blocks on a
    card of ``sms`` SMs: the smallest G <= 8 whose head slots fit shared
    memory and whose G * blocks CTAs (one an SM) fill at least half the SMs,
    else the largest G whose slots fit."""
    best = 0
    for g in range(1, min(BTC_OUT_SM90_MAX_CLUSTER, heads) + 1):
        if btc_out_sm90_smem_bytes(heads, g) > BTC_OUT_SM90_MAX_SMEM:
            continue
        best = g
        if 2 * g * blocks >= sms:
            break
    return best


def btc_out_sm90_chunk_group(c_out: int, groups: int) -> int:
    """Output chunks of 64 columns an epilogue pass takes: the most chunks a
    CTA has (its share of C / 64) in the fewest passes of at most
    ``BTC_OUT_SM90_MAX_CHUNKS``, evened out."""
    most = -(-(c_out // 64) // groups)
    passes = -(-most // BTC_OUT_SM90_MAX_CHUNKS)
    return -(-most // passes)


def btc_out_sm90_smem_bytes(heads: int, groups: int) -> int:
    """Dynamic shared memory of one CTA: 1 KB of alignment slack, ceil(H / G)
    16 KB head slots, two 16 KB Q slots and a three-stage 32 KB K/V ring
    (the epilogue's staging slots and wo ring in their place), 22 barriers."""
    return 1024 + 16384 * (-(-heads // groups) + 2 + 2 * 3) + 8 * 22


def train_attn_chunk(t: int, chunk: int = TRAIN_ATTN_CHUNK) -> int:
    """Query rows per backward recompute (JAX ``_train_attn_chunk``, attention.py:138-174).

    ``t`` itself when t <= 2 * chunk; else ``chunk`` when it divides t, else the
    largest divisor of t not above ``chunk`` (``t`` when that is below 64).
    """
    if t <= 2 * chunk:
        return t
    if t % chunk == 0:
        return chunk
    best = max(d for d in range(1, chunk + 1) if t % d == 0)
    return best if best >= 64 else t


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


def _heads(x):
    """(B, T, H*64) -> (B, H, T, 64) view."""
    b, t, inner = x.shape
    return x.reshape(b, t, inner // 64, 64).transpose(1, 2)


def attention_btc_plain(q, k, v):
    """``attention_bh_plain`` per 64-wide head window of (B, T, H*64) tensors."""
    b, t, inner = q.shape
    o = attention_bh_plain(_heads(q), _heads(k), _heads(v))
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
    return cuda_lib.tolerance_ratio(out, ref, BF16_RTOL, BF16_ATOL_RMS)


# The out-projection-fused kernel agrees with its plain version when, elementwise,
#     |out - ref| <= BF16_RTOL * |ref| + BF16_OUT_ATOL_RMS * rms(ref).
# Both round each per-head output o_i to bf16, where near one ulp (at most
# 2^-7 |o_i|) can flip between them, as above; then each output sums the
# ``inner`` products o_i * wo_ij in fp32 and rounds once. The flips enter that
# sum with random signs, so their effect has an rms of at most 2^-7 rms(ref)
# even if every term flipped a whole ulp; the absolute term is four times that
# bound, 2^-5 rms(ref). The final rounding adds at most one ulp, 2^-7 |ref|.
# A head left out of the sum, or a dropped 64-row chunk of wo, removes about
# rms(ref) / sqrt(H) (0.22 at H = 20, 0.45 at H = 5) and reads 7 or more.
BF16_OUT_ATOL_RMS = 2.0 ** -5


def bf16_out_tolerance_ratio(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| / (BF16_RTOL |ref| + BF16_OUT_ATOL_RMS rms(ref)); at most 1 to agree."""
    return cuda_lib.tolerance_ratio(out, ref, BF16_RTOL, BF16_OUT_ATOL_RMS)


# ---------------------------------------------------------------------------
# backward: JAX's reference function at scale ln 2, recomputed by query chunk
# ---------------------------------------------------------------------------


def attention_reference(q, k, v):
    """softmax_e(ln2 * q k^T) v over (..., T, D): JAX ``_xla_reference_bh`` at scale ln 2."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * LN2
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p, v)


def attention_vjp(q, k, v, g, chunk: int | None = None):
    """(dq, dk, dv) of ``attention_reference`` at cotangent ``g``, over (..., T, D).

    Queries go ``chunk`` rows at a time (default ``train_attn_chunk(T)``); the
    key and value gradients sum over the chunks in fp32.
    """
    t = q.shape[-2]
    chunk = chunk or train_attn_chunk(t)
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    with torch.enable_grad():
        kk, vv = k.detach().requires_grad_(), v.detach().requires_grad_()
        for i in range(0, t, chunk):
            qc = q[..., i:i + chunk, :].detach().requires_grad_()
            o = attention_reference(qc, kk, vv)
            gq, gk, gv = torch.autograd.grad(o, (qc, kk, vv), g[..., i:i + chunk, :])
            dq[..., i:i + chunk, :] = gq
            dk += gk
            dv += gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def attention_btc_vjp(q, k, v, g, chunk: int | None = None):
    """``attention_vjp`` per 64-wide head window of (B, T, H*64) tensors."""
    b, t, inner = q.shape
    grads = attention_vjp(_heads(q), _heads(k), _heads(v), _heads(g), chunk)
    return tuple(x.transpose(1, 2).reshape(b, t, inner) for x in grads)


def attention_btc_out_plain(q, k, v, wo):
    """``attention_btc_plain`` (rounded to q's dtype), then @ wo in fp32, rounded once."""
    o = attention_btc_plain(q, k, v)
    return (o.float() @ wo.float()).to(q.dtype)


def attention_btc_out_vjp(q, k, v, wo, g, chunk: int | None = None):
    """(dq, dk, dv, dwo) of ``attention_reference`` per head, times ``wo``.

    JAX ``_make_diffable_btc_out``'s backward (pallas_attention.py:435-456):
    queries go ``chunk`` rows at a time as in ``attention_vjp``; the key,
    value and ``wo`` gradients sum over the chunks in fp32.
    """
    b, t, inner = q.shape
    chunk = chunk or train_attn_chunk(t)
    qh, kh, vh = _heads(q), _heads(k), _heads(v)
    dq = torch.empty(qh.shape, dtype=q.dtype, device=q.device)
    dk = torch.zeros(kh.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(vh.shape, dtype=torch.float32, device=v.device)
    dwo = torch.zeros(wo.shape, dtype=torch.float32, device=wo.device)
    with torch.enable_grad():
        kk, vv = kh.detach().requires_grad_(), vh.detach().requires_grad_()
        w = wo.detach().requires_grad_()
        for i in range(0, t, chunk):
            qc = qh[..., i:i + chunk, :].detach().requires_grad_()
            o = attention_reference(qc, kk, vv)  # (B, H, chunk, 64)
            out = o.transpose(1, 2).reshape(b, -1, inner) @ w
            gq, gk, gv, gw = torch.autograd.grad(out, (qc, kk, vv, w), g[:, i:i + chunk])
            dq[..., i:i + chunk, :] = gq
            dk += gk
            dv += gv
            dwo += gw
    return (*(x.transpose(1, 2).reshape(b, t, inner).to(q.dtype) for x in (dq, dk, dv)),
            dwo.to(wo.dtype))


# ---------------------------------------------------------------------------
# bind
# ---------------------------------------------------------------------------


@functools.cache
def library() -> ctypes.CDLL:
    """``csrc/attention.cu``, built unless a library of the same source hash exists."""
    lib = ctypes.CDLL(str(cuda_lib.build_all([SOURCE])[0]))
    for name in ("ur_attention_btc", "ur_attention_bh", "ur_attention_stream"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.ur_attention_btc_out.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                                         + [ctypes.c_void_p])
    lib.ur_attention_btc_out.restype = ctypes.c_int
    return lib


def _load(source: Path, symbol: str, pointers: int = 4, ints: int = 4) -> ctypes.CDLL:
    """The library of ``source`` with C entry ``symbol`` (``pointers`` tensors:
    q, k, v, o or q, k, v, wo, out; ``ints`` ints; the stream) bound, built
    unless a library of the same source hash exists."""
    lib = ctypes.CDLL(str(cuda_lib.build_all([source])[0]))
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def library_sm90() -> ctypes.CDLL:
    """``csrc/attention_sm90.cu``, built unless a library of the same source hash exists."""
    return _load(SOURCE_SM90, "ur_attention_btc_sm90")


@functools.cache
def library_stream_sm90() -> ctypes.CDLL:
    """``csrc/attention_stream_sm90.cu``, built unless a library of the same source hash exists."""
    return _load(SOURCE_STREAM_SM90, "ur_attention_stream_sm90")


@functools.cache
def library_bh_sm90() -> ctypes.CDLL:
    """``csrc/attention_bh_sm90.cu``, built unless a library of the same source hash exists."""
    return _load(SOURCE_BH_SM90, "ur_attention_bh_sm90")


@functools.cache
def library_out_sm90() -> ctypes.CDLL:
    """``csrc/attention_out_sm90.cu``, built unless a library of the same source hash exists."""
    return _load(SOURCE_OUT_SM90, "ur_attention_btc_out_sm90", pointers=5, ints=5)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


class _AttentionFunction(torch.autograd.Function):
    """Kernel forward, plain-PyTorch recompute backward (the JAX custom VJP)."""

    @staticmethod
    def forward(ctx, kern, *xs):
        ctx.kern = kern
        ctx.save_for_backward(*xs)
        return kern.forward(*xs)

    @staticmethod
    def backward(ctx, g):
        ctx.kern.backwards += 1
        return (None, *ctx.kern.vjp(*ctx.saved_tensors, g))


class AttentionKernel(cuda_lib.KernelWrapper):
    """One kernel entry: plain version on the CPU, the CUDA kernel on the card.

    Takes q, k, v (the out-projection-fused entry also ``wo``). ``dims(q, *rest)``
    checks the shapes against the kernel's predicate and returns the int
    arguments of the C entry ``symbol``; ``vjp`` is the backward; the output
    has q's dtype and the shape ``out_shape(q, k, v, *rest)``. ``bf16_tolerance_ratio``
    is the limit a bf16 launch is held to against ``plain``. ``symbols`` names
    another C entry, as (symbol, library loader, source), for the dtypes it
    lists; every other launch takes ``symbol`` in ``csrc/attention.cu``.
    """

    base = (library, SOURCE)

    def __init__(self, symbol: str, plain, vjp, dims, replaces: str,
                 out_shape=lambda q, *rest: q.shape, tolerance=bf16_tolerance_ratio,
                 symbols=None):
        self.symbol = symbol
        self.symbols = symbols or {}
        self.plain = plain
        self.vjp = vjp
        self.dims = dims
        self.out_shape = out_shape
        self.bf16_tolerance_ratio = tolerance
        self.replaces = replaces
        super().__init__()

    def __call__(self, q, k, v, *rest):
        return _AttentionFunction.apply(self, q, k, v, *rest)

    def forward(self, q, k, v, *rest):
        xs = (q, k, v, *rest)
        devices = {x.device.type for x in xs}
        if devices == {"cpu"}:
            return self.plain(*xs)
        names = "q, k, v" + ", wo" * len(rest)
        if devices != {"cuda"} or len({x.device for x in xs}) != 1:
            raise ValueError(f"{self.symbol}: {names} must lie on one CUDA device, "
                             f"got {', '.join(str(x.device) for x in xs)}")
        if q.dtype not in cuda_lib.DTYPE_CODES or any(x.dtype != q.dtype for x in xs):
            raise TypeError(f"{self.symbol}: dtypes {', '.join(str(x.dtype) for x in xs)}; "
                            "want all float32 or all bfloat16")
        if not q.shape == k.shape == v.shape:
            raise ValueError(f"{self.symbol}: shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                             f"{tuple(v.shape)} differ")
        if not all(x.is_contiguous() for x in xs):
            raise ValueError(f"{self.symbol}: {names} must be contiguous")
        if any(x.data_ptr() % 16 for x in xs):
            raise ValueError(f"{self.symbol}: {names} must start on 16-byte boundaries")
        dims = self.dims(q, *rest)
        out = torch.empty(self.out_shape(*xs), dtype=q.dtype, device=q.device)
        with torch.cuda.device(q.device):
            symbol, lib = self.route(q.dtype)
            rc = getattr(lib, symbol)(
                *(x.data_ptr() for x in xs), out.data_ptr(), *dims,
                cuda_lib.DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream)
        self.counted(rc, symbol, q)
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


def _btc_out_dims(q, wo):
    """Every non-empty shape the fused route admits (``btc_supported`` and
    ``btc_out_supported``) up to ``BTC_OUT_MAX_INNER``."""
    if (q.dim() != 3 or wo.dim() != 2 or wo.shape[0] != q.shape[2] or 0 in wo.shape
            or not btc_supported(q.shape[1], q.shape[1], q.shape[2], 64)
            or not btc_out_supported(wo.shape[1]) or q.shape[2] > BTC_OUT_MAX_INNER):
        raise ValueError(f"out-projection-fused attention: unsupported shapes q "
                         f"{tuple(q.shape)}, wo {tuple(wo.shape)}")
    return q.shape[0], q.shape[1], q.shape[2], wo.shape[1]


fused_attention_btc_prescaled = AttentionKernel(
    "ur_attention_btc", attention_btc_plain, attention_btc_vjp, _btc_dims,
    "unirestore_tpu/nn/pallas_attention.py:220",
    symbols={torch.bfloat16: ("ur_attention_btc_sm90", library_sm90, SOURCE_SM90)})
fused_attention_bh_prescaled = AttentionKernel(
    "ur_attention_bh", attention_bh_plain, attention_vjp, _bh_dims,
    "unirestore_tpu/nn/pallas_attention.py:32",
    symbols={torch.bfloat16: ("ur_attention_bh_sm90", library_bh_sm90, SOURCE_BH_SM90)})
streaming_attention_bh_prescaled = AttentionKernel(
    "ur_attention_stream", attention_bh_plain, attention_vjp, _stream_dims,
    "unirestore_tpu/nn/pallas_attention.py:83",
    symbols={torch.bfloat16: ("ur_attention_stream_sm90", library_stream_sm90,
                              SOURCE_STREAM_SM90)})
fused_attention_btc_out_prescaled = AttentionKernel(
    "ur_attention_btc_out", attention_btc_out_plain, attention_btc_out_vjp, _btc_out_dims,
    "unirestore_tpu/nn/pallas_attention.py:269",
    out_shape=lambda q, k, v, wo: (*q.shape[:2], wo.shape[1]), tolerance=bf16_out_tolerance_ratio,
    symbols={torch.bfloat16: ("ur_attention_btc_out_sm90", library_out_sm90, SOURCE_OUT_SM90)})

KERNELS = (fused_attention_btc_prescaled, fused_attention_bh_prescaled,
           streaming_attention_bh_prescaled, fused_attention_btc_out_prescaled)
