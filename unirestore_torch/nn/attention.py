"""Attention for the SD VAE/UNet/Controller (mirrors ``unirestore_tpu/nn/attention.py``).

``mha`` routes by shape alone, with the JAX package's predicates:

- self-attention, T >= 1024, T % 256 == 0, d = 64: channel-flat kernel
  (``fused_attention_btc_prescaled``) on the (B, T, inner) projections; under
  ``fused_out_projection(True)`` and for an out-projection width C with
  C % 128 == 0 or C in (320, 640), the kernel with the out-projection fused
  (``fused_attention_btc_out_prescaled``), the bias added after it;
- self-attention, T >= 256, d in {64, 128}: head-major kernel
  (``fused_attention_bh_prescaled``);
- self-attention, 128 < d <= 512, T >= 1024, T % 1024 == 0: streaming kernel
  (``streaming_attention_bh_prescaled``);
- everything else (77-token cross-attention, short sequences): plain
  matmul / fp32 softmax / matmul, as ``jax.nn.dot_product_attention``.

The kernel routes fold ``scale * log2(e)`` into the q weights in the
activation dtype and take a base-2 softmax, as the JAX function does
(attention.py:227-234, 251-252). On CPU tensors the kernel wrappers compute
their plain PyTorch versions. Tokens are (B, T, C), feature maps NHWC.

Training keeps the same routes: each kernel wrapper is an autograd function
whose backward recomputes the attention in plain PyTorch over query chunks
(``attention_kernels.attention_vjp``). The JAX package traced its training
under ``force_xla_attention`` (attention.py:59-80) only because its remote
compiler could not take the mixed Pallas-forward / XLA-backward graph; the
function is the same either way, and the card has no such compiler. The plain
route (77-token cross-attention, short sequences) stays on plain autograd.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from ..parallel import spatial as SP
from . import attention_kernels as K
from . import layers as L


def mha_init(ini, query_dim: int, heads: int, dim_head: int,
             context_dim: int | None = None, qkv_bias: bool = False):
    inner = heads * dim_head
    ctx = context_dim if context_dim is not None else query_dim
    return {
        "to_q": L.linear_init(ini, query_dim, inner, bias=qkv_bias),
        "to_k": L.linear_init(ini, ctx, inner, bias=qkv_bias),
        "to_v": L.linear_init(ini, ctx, inner, bias=qkv_bias),
        "to_out": L.linear_init(ini, inner, query_dim, bias=True),
    }


# The JAX package reads UNIRESTORE_FUSED_OUT_ATTN=1 at trace time
# (attention.py:111-126) and leaves the fused route off by default; the port
# takes the switch from its caller (``UniRestoreConfig.fused_out_attention``).
# Like the JAX package's ``force_xla_attention`` it is one flag for the
# process (not per thread): callers that restore with different settings
# serialise their calls, as the server does. Training never sets it.
_FUSED_OUT = False


@contextlib.contextmanager
def fused_out_projection(enabled: bool = True):
    """Within the block, channel-flat self-attention fuses the out-projection
    into its kernel where ``_use_btc_fused_out`` admits the width."""
    global _FUSED_OUT
    prev, _FUSED_OUT = _FUSED_OUT, bool(enabled)
    try:
        yield
    finally:
        _FUSED_OUT = prev


def _use_btc_fused_out(c_out: int) -> bool:
    """JAX ``_use_btc_fused_out``: the switch, then the width test."""
    return _FUSED_OUT and K.btc_out_supported(c_out)


@functools.cache
def _host_gain(gain: float, dtype: torch.dtype) -> float:
    """``gain`` rounded to ``dtype``, as a Python float. A tensor times it
    rounds as the tensor times a ``dtype`` tensor holding ``gain`` does (both
    multiply in fp32 and round once), and no tensor goes to the device: a copy
    from host memory synchronises the stream and cannot be graph-captured."""
    return torch.tensor(gain, dtype=dtype).item()


def _prescaled_linear(pp, x, gain: float):
    """``x @ (w * gain) + b * gain`` with ``gain`` rounded to x's dtype."""
    g = _host_gain(gain, x.dtype)
    y = x @ (pp["w"].to(x.dtype) * g)
    if "b" in pp:
        y = y + pp["b"].to(x.dtype) * g
    return y


def _head_major(y, heads: int):
    """(B, T, H*D) -> contiguous (B*H, T, D); for B = 1 the reshape alone
    would return a strided view, which the kernels do not take."""
    b, t, inner = y.shape
    y = y.reshape(b, t, heads, inner // heads).transpose(1, 2)
    return y.reshape(b * heads, t, -1).contiguous()


def mha(p, x, context=None, heads: int = 8):
    """Multi-head attention over (B, T, C) with optional (B, S, Cctx) context.

    Self-attention over a height-sharded slab's tokens (``parallel/spatial.py``)
    gathers every rank's tokens to the global (B, T, C), runs whole, so that
    the routing sees the global T, and keeps this rank's rows: what GSPMD does
    with a ``pallas_call`` it cannot partition. Cross-attention to the text
    context runs on the slab."""
    if context is None and SP.current() is not None:
        return SP.local_rows(_mha(p, SP.gather_rows(x), None, heads), x.shape[1])
    return _mha(p, x, context, heads)


def _mha(p, x, context, heads: int):
    ctx = x if context is None else context
    b, t, _ = x.shape
    s = ctx.shape[1]
    inner = p["to_q"]["w"].shape[1]
    dim_head = inner // heads
    scale = float(dim_head) ** -0.5

    use_fused = K.supported(t, s, dim_head)
    if use_fused and K.btc_supported(t, s, inner, dim_head):
        qf = _prescaled_linear(p["to_q"], x, scale * K.LOG2E)
        kf, vf = L.linear(p["to_k"], ctx), L.linear(p["to_v"], ctx)
        po = p["to_out"]
        # the kernel's per-head output tile must fit shared memory; every
        # sd-turbo width does (inner <= 1280)
        if _use_btc_fused_out(po["w"].shape[1]) and inner <= K.BTC_OUT_MAX_INNER:
            out = K.fused_attention_btc_out_prescaled(qf, kf, vf, po["w"].to(x.dtype))
            return out + po["b"].to(x.dtype) if "b" in po else out
        return L.linear(po, K.fused_attention_btc_prescaled(qf, kf, vf))
    use_streaming = not use_fused and K.stream_supported(t, s, dim_head)
    if use_fused or use_streaming:
        qb = _head_major(_prescaled_linear(p["to_q"], x, scale * K.LOG2E), heads)
        kb = _head_major(L.linear(p["to_k"], ctx), heads)
        vb = _head_major(L.linear(p["to_v"], ctx), heads)
        kernel = (K.fused_attention_bh_prescaled if use_fused
                  else K.streaming_attention_bh_prescaled)
        ob = kernel(qb, kb, vb)  # (B*H, T, D)
        o = ob.reshape(b, heads, t, dim_head).transpose(1, 2).reshape(b, t, inner)
        return L.linear(p["to_out"], o)

    q = L.linear(p["to_q"], x).reshape(b, t, heads, dim_head).transpose(1, 2)
    k = L.linear(p["to_k"], ctx).reshape(b, s, heads, dim_head).transpose(1, 2)
    v = L.linear(p["to_v"], ctx).reshape(b, s, heads, dim_head).transpose(1, 2)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.matmul(probs, v)  # (B, H, T, D)
    return L.linear(p["to_out"], o.transpose(1, 2).reshape(b, t, inner))


def spatial_self_attention_init(ini, channels: int, heads: int):
    return {
        "group_norm": L.norm_init(ini, channels),
        "attn": mha_init(ini, channels, heads, channels // heads, qkv_bias=True),
    }


def spatial_self_attention(p, x, heads: int, groups: int = 32, eps: float = 1e-6):
    """VAE/Controller-style residual spatial self-attention on an NHWC map."""
    b, h, w, c = x.shape
    y = L.group_norm(p["group_norm"], x, groups=groups, eps=eps)
    y = mha(p["attn"], y.reshape(b, h * w, c), heads=heads)
    return x + y.reshape(b, h, w, c)
