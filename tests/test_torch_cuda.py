"""The CUDA attention kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. On a machine with a
card (which has no JAX, so the repo's conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: fp32 1e-5 (same fp32 arithmetic, other summation order); bf16
``attention_kernels.bf16_tolerance_ratio <= 1``, the limit chip_smoke.py holds
the kernels to: |out - ref| <= 2^-7 |ref| + 0.03 rms(ref) elementwise (one
bf16 ulp of the output, plus the probabilities' rounding near zero).
"""

import pytest
import torch

from unirestore_torch.nn import attention as TA
from unirestore_torch.nn import attention_kernels as K
from unirestore_torch.nn import layers as TL

pytestmark = pytest.mark.cuda

FP32_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _qkv(shape, d, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device="cuda") for _ in range(3))
    return (q * d ** -0.5 * K.LOG2E).to(dtype), k.to(dtype), v.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,shape,d", [
    ("btc", (2, 1024, 128), 64),
    ("btc", (1, 1280, 320), 64),
    ("bh", (3, 256, 64), 64),
    ("bh", (3, 264, 64), 64),     # T not a multiple of the 64-row tiles: masked edges
    ("bh", (2, 328, 128), 128),
    ("stream", (1, 1024, 512), 512),
    ("stream", (2, 2048, 256), 256),
    ("stream", (1, 1024, 384), 384),
])
def test_kernel_matches_plain(cuda, dtype, name, shape, d):
    kern = {"btc": K.fused_attention_btc_prescaled, "bh": K.fused_attention_bh_prescaled,
            "stream": K.streaming_attention_bh_prescaled}[name]
    q, k, v = _qkv(shape, d, dtype)
    before = kern.launches
    out = kern(q, k, v)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    ref = kern.plain(q, k, v)
    if dtype == torch.bfloat16:
        assert K.bf16_tolerance_ratio(out, ref) <= 1.0
    else:
        torch.testing.assert_close(out, ref, **FP32_TOL)


def test_kernel_wrapper_raises_on_what_it_cannot_run(cuda):
    q, k, v = _qkv((2, 256, 64), 64, torch.float32)
    kern = K.fused_attention_bh_prescaled
    with pytest.raises(TypeError):
        kern(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        kern(q.transpose(0, 1).contiguous().transpose(0, 1), k, v)
    with pytest.raises(ValueError, match="unsupported"):
        kern(q[:, :200].contiguous(), k[:, :200].contiguous(), v[:, :200].contiguous())
    shifted = torch.empty(q.numel() + 1, device="cuda")[1:].view(q.shape)  # 4 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        kern(shifted, k, v)
    with pytest.raises(RuntimeError, match="grad"):
        kern(q.requires_grad_(), k, v)
    with pytest.raises(ValueError, match="CUDA device"):
        kern(q.detach(), k.cpu(), v)


@pytest.mark.parametrize("t,dim,heads", [(1024, 128, 2), (256, 256, 2), (1024, 512, 1)])
def test_mha_on_card_matches_cpu(cuda, t, dim, heads):
    g = torch.Generator().manual_seed(1)
    p = {name: {"w": torch.randn(dim, dim, generator=g) * dim ** -0.5,
                "b": torch.randn(dim, generator=g) * 0.1}
         for name in ("to_q", "to_k", "to_v", "to_out")}
    x = torch.randn(2, t, dim, generator=g)
    cpu = TA.mha(p, x, heads=heads)
    p_cuda = {n: {k: v.cuda() for k, v in pp.items()} for n, pp in p.items()}
    launches = sum(kern.launches for kern in K.KERNELS)
    out = TA.mha(p_cuda, x.cuda(), heads=heads)
    assert sum(kern.launches for kern in K.KERNELS) == launches + 1
    torch.testing.assert_close(out.cpu(), cpu, **FP32_TOL)


def test_conv2d_channels_last_on_card(cuda):
    """The NHWC conv hands cuDNN a channels_last view; it must equal the CPU result."""
    g = torch.Generator().manual_seed(2)
    p = {"w": torch.randn(32, 2, 3, 3, generator=g), "b": torch.randn(32, generator=g)}
    x = torch.randn(2, 9, 11, 32, generator=g)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # fp32 convs, as on the CPU
    try:
        out = TL.conv2d({k: v.cuda() for k, v in p.items()}, x.cuda(), padding=1, groups=16)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    torch.testing.assert_close(out.cpu(), TL.conv2d(p, x, padding=1, groups=16), **FP32_TOL)
