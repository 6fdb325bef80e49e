"""The yardstick's frozen arithmetic of the device: peaks, the five hand
kernels' operations and bytes, which kernel each attention call reaches, and
the kernel families of a trace.

Copied, not imported, from the program (`chip_smoke.py`'s `bound` and phase
3's counts, `nn/attention_kernels.py`'s shape predicates,
`tools/profile_torch_restore.py:FAMILIES`), so that a roofline share reads
the same work whatever a later change does to the program.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16_BYTES = 2

# kernel-name substrings -> family, first match wins (a frozen copy of
# tools/profile_torch_restore.py:FAMILIES)
FAMILIES = (
    ("attention_btc_sm90", "channel-flat attention kernel (this repo, attention_sm90.cu)"),
    ("attention_stream_sm90",
     "wide-head attention kernel (this repo, attention_stream_sm90.cu)"),
    ("attention_bh_sm90", "head-major attention kernel (this repo, attention_bh_sm90.cu)"),
    ("attention_out_sm90",
     "out-projection-fused attention kernel (this repo, attention_out_sm90.cu)"),
    ("attention_fwd", "attention kernels (this repo, attention.cu)"),
    ("gconv3_sm90", "grouped-conv kernel (this repo, grouped_conv_sm90.cu)"),
    ("gconv3_", "grouped-conv kernel (this repo, grouped_conv.cu)"),
    ("conv", "convolution (cuDNN)"), ("xmma", "convolution (cuDNN)"),
    ("implicit_gemm", "convolution (cuDNN)"), ("winograd", "convolution (cuDNN)"),
    ("gemm", "matmul (cuBLAS)"), ("cutlass", "matmul (cuBLAS)"), ("nvjet", "matmul (cuBLAS)"),
    ("softmax", "softmax (attention backward recompute)"),
    ("reduce", "reductions (norm statistics, means)"),
    ("copy", "copies and dtype casts"), ("cat", "copies and dtype casts"),
    ("elementwise", "other elementwise"),
)
NORM_ELEMENTWISE = ("other elementwise", "reductions (norm statistics, means)")

# the hand kernels on the card, by the name their device function carries
HAND_KERNELS = ("attention_btc_sm90", "attention_bh_sm90", "attention_stream_sm90",
                "attention_out_sm90", "gconv3_sm90")


def family(name: str) -> str:
    low = name.lower()
    for key, fam in FAMILIES:
        if key in low:
            return fam
    return "other"


def hand_kernel(name: str) -> str | None:
    """The hand kernel a device function's name belongs to, else None."""
    for key in HAND_KERNELS:
        if key in name:
            return key
    return None


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def attention_cost(b: int, heads: int, t: int, d: int) -> tuple:
    """(operations, bytes) of bf16 self-attention over ``heads`` heads of width
    ``d``: two products of 2 t t d a head; q, k, v read and o written once."""
    return 4.0 * b * heads * t * t * d, 4.0 * b * t * heads * d * BF16_BYTES


def grouped_conv_cost(b: int, h: int, w: int, c: int, groups: int = 16) -> tuple:
    """(operations, bytes) of the bf16 3x3 grouped convolution: x read and y
    written once, the weights and bias read once."""
    flops = 2.0 * b * h * w * c * 9 * (c // groups)
    return flops, (2 * b * h * w * c + c * (c // groups) * 9 + c) * BF16_BYTES


def attention_route(t: int, s: int, d: int, inner: int) -> str | None:
    """The hand kernel a bf16 attention call reaches, or None for the plain
    route (frozen copy of the program's predicates: the channel-flat kernel
    at T >= 1024, T % 256 == 0, d = 64; the head-major kernel at T >= 256,
    d in 64..128; the streaming kernel at 128 < d <= 512, T % 1024 == 0)."""
    if t != s:
        return None
    head_major = t >= 256 and t % 8 == 0 and d % 64 == 0 and d <= 128
    if head_major and t >= 1024 and t % 256 == 0 and d == 64 and inner % 64 == 0:
        return "attention_btc_sm90"
    if head_major:
        return "attention_bh_sm90"
    if t >= 1024 and t % 1024 == 0 and 128 < d <= 512 and d % 128 == 0:
        return "attention_stream_sm90"
    return None


def grouped_conv_route(c: int, groups: int) -> str | None:
    """The grouped-conv kernel takes 16, 32, 64 or 128 channels a group."""
    return "gconv3_sm90" if c % groups == 0 and c // groups in (16, 32, 64, 128) else None


def kernel_calls(record: list) -> dict:
    """{hand kernel: [(operations, bytes), ...]} of one call of the model,
    from the attention calls and grouped convolutions the reference recorded
    (``model.restore``'s ``record``)."""
    out: dict = {}
    for op in record:
        if op["op"] == "attention":
            kern = attention_route(op["t"], op["s"], op["d"], op["heads"] * op["d"])
            cost = attention_cost(op["b"], op["heads"], op["t"], op["d"])
        else:
            kern = grouped_conv_route(op["shape"][3], op["groups"])
            cost = grouped_conv_cost(*op["shape"], op["groups"])
        if kern is not None:
            out.setdefault(kern, []).append(cost)
    return out
