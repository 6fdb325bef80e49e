"""The CUDA kernels against their plain versions, on the card, with gradients.

Marked ``cuda``: each test skips without a CUDA device. On a machine with a
card (which has no JAX, so the repo's conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: fp32 1e-5 (same fp32 arithmetic, other summation order); bf16
``attention_kernels.bf16_tolerance_ratio <= 1``, the limit chip_smoke.py holds
the kernels to: |out - ref| <= 2^-7 |ref| + 0.03 rms(ref) elementwise (one
bf16 ulp of the output, plus the probabilities' rounding near zero); for the
grouped conv ``grouped_conv.bf16_tolerance_ratio <= 1`` (two bf16 ulps plus
2^-10 rms(ref)). Gradients through the autograd functions against autograd
through the plain versions: fp32 1e-4 (the recompute backward differentiates
softmax_e(ln2 s) where the plain version takes exp2 and divides at the end),
bf16 rms error <= 2^-6 of the reference's rms (chip_smoke.BWD_RMS_TOL).
The bf16 channel-flat launches go through ``ur_attention_btc_sm90``
(``csrc/attention_sm90.cu``), the fp32 ones through ``ur_attention_btc``; the
bf16 wide-head launches through ``ur_attention_stream_sm90``
(``csrc/attention_stream_sm90.cu``), the fp32 ones through
``ur_attention_stream``; the bf16 head-major launches through
``ur_attention_bh_sm90`` (``csrc/attention_bh_sm90.cu``), the fp32 ones
through ``ur_attention_bh``; the bf16 grouped-conv launches through
``ur_grouped_conv3_sm90`` (``csrc/grouped_conv_sm90.cu``), the fp32 ones
through ``ur_grouped_conv3``. A selection test holds each Hopper kernel's
wgmma descriptors and TMA swizzle (and the head-major kernel's masked tail,
the grouped conv's halo and edges) to exact answers (``pytest -k btc``,
``-k stream``, ``-k bh`` or ``-k gconv`` runs only one kernel's tests while
iterating on it).
The bf16 out-projection-fused launches go through ``ur_attention_btc_out_sm90``
(``csrc/attention_out_sm90.cu``, ``-k btc_out``), the fp32 ones through
``ur_attention_btc_out``; its selection test holds the cluster exchange, the
column shares and the wo tiles to exact answers.
The out-projection-fused kernel: bf16 ``bf16_out_tolerance_ratio <= 1``
(|out - ref| <= 2^-7 |ref| + 2^-5 rms(ref), the reasoning beside it in
``attention_kernels.py``); fp32 1e-5 of the output's largest entry, since each
output sums ``inner`` (up to 1280) products in another order than the plain
version's matmul.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from unirestore_torch.nn import attention as TA
from unirestore_torch.nn import attention_kernels as K
from unirestore_torch.nn import grouped_conv as G
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
    ("btc", (1, 1024, 64), 64),
    ("btc", (8, 1024, 640), 64),
    ("btc", (1, 4096, 1280), 64),
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


def test_btc_sm90_selects_exact_rows(cuda):
    """Each query's logits put one key (a permutation of all 1024: every key
    tile, every row of each 128-byte swizzle atom, every ring stage) at least
    160 above every other, so exp2 of the others is 0 in fp32 and the output
    must equal the selected V rows bit for bit. A wrong K descriptor picks
    another key; a wrong V descriptor, swizzle or transpose bit permutes or
    mixes V's columns."""
    rng = np.random.default_rng(0)
    t, d = 1024, 64
    codes = rng.choice([-1.0, 1.0], size=(t, d))
    # distinct +-1 codes at Hamming distance >= 10: q_i . k_j = 8 (64 - 2 dist)
    dist = (d - codes @ codes.T) / 2
    np.fill_diagonal(dist, d)
    assert dist.min() >= 10
    perm = rng.permutation(t)
    q = torch.tensor(8.0 * codes[perm], dtype=torch.bfloat16, device="cuda")[None]
    k = torch.tensor(codes, dtype=torch.bfloat16, device="cuda")[None]
    v = torch.randn((1, t, d), generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda").to(torch.bfloat16)
    symbol, _ = K.fused_attention_btc_prescaled.route(torch.bfloat16)
    assert symbol == "ur_attention_btc_sm90"
    out = K.fused_attention_btc_prescaled(q, k, v)
    torch.cuda.synchronize()
    want = v[:, torch.from_numpy(perm).cuda()]
    wrong = (out != want).any(-1)[0].nonzero().flatten().tolist()
    assert not wrong, f"{len(wrong)} rows differ, first {wrong[:8]}"


def _launch_takes(monkeypatch, kern, shape, d, dtype):
    """The C entry one launch of ``kern`` took."""
    chosen, route = [], kern.route

    def spy(dt):
        chosen.append(route(dt)[0])
        return route(dt)

    monkeypatch.setattr(kern, "route", spy)
    q, k, v = _qkv(shape, d, dtype)
    before = kern.launches
    kern(q, k, v)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    return chosen


@pytest.mark.parametrize("dtype,symbol", [(torch.bfloat16, "ur_attention_btc_sm90"),
                                          (torch.float32, "ur_attention_btc")])
def test_btc_launch_takes_the_entry_of_its_dtype(cuda, monkeypatch, dtype, symbol):
    kern = K.fused_attention_btc_prescaled
    assert _launch_takes(monkeypatch, kern, (1, 1024, 128), 64, dtype) == [symbol]


@pytest.mark.parametrize("shape", [(2, 1024, 128), (1, 1280, 320), (8, 1024, 640),
                                   (1, 4096, 1280)])
def test_btc_sm90_matches_the_mma_sync_kernel(cuda, shape):
    q, k, v = _qkv(shape, 64, torch.bfloat16, seed=2)
    out = K.fused_attention_btc_prescaled(q, k, v)
    prev = chip_smoke.direct(K.library().ur_attention_btc, q, k, v)
    torch.cuda.synchronize()
    assert K.bf16_tolerance_ratio(out, prev) <= 1.0


@pytest.mark.parametrize("d", [256, 384, 512])
def test_stream_sm90_selects_exact_rows(cuda, d):
    """In each of two heads, each query's logits put one key (a permutation of
    all 1024: every key tile, every row of each 128-byte swizzle atom, every
    ring slot) at least 160 above every other, so exp2 of the others is 0 in
    fp32 and every one of the d output columns must equal the selected V row
    bit for bit. A wrong K descriptor picks another key; a wrong V descriptor,
    swizzle or transpose bit permutes or mixes V's columns; a consumer that
    writes the other's columns, reads an off-by-one V chunk or drops the
    other's partial S gives wrong rows; a wrong head offset reads another
    head's keys."""
    rng = np.random.default_rng(d)
    bh, t = 2, 1024
    codes = rng.choice([-1.0, 1.0], size=(bh, t, d))
    for c in codes:
        # distinct +-1 codes: q_i . k_j = d - 2 dist(i, j), the selected key
        # ahead of every other by 2 dist
        dist = (d - c @ c.T) / 2
        np.fill_diagonal(dist, d)
        assert 2 * dist.min() >= 160
    perms = [rng.permutation(t) for _ in range(bh)]
    q = torch.tensor(np.stack([c[p] for c, p in zip(codes, perms)]), dtype=torch.bfloat16,
                     device="cuda")
    k = torch.tensor(codes, dtype=torch.bfloat16, device="cuda")
    v = torch.randn((bh, t, d), generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda").to(torch.bfloat16)
    kern = K.streaming_attention_bh_prescaled
    assert kern.route(torch.bfloat16)[0] == "ur_attention_stream_sm90"
    out = kern(q, k, v)
    torch.cuda.synchronize()
    want = torch.stack([v[i, torch.from_numpy(p).cuda()] for i, p in enumerate(perms)])
    wrong = (out != want).any(-1).nonzero().tolist()
    assert not wrong, f"{len(wrong)} (head, row) pairs differ, first {wrong[:8]}"


@pytest.mark.parametrize("dtype,symbol", [(torch.bfloat16, "ur_attention_stream_sm90"),
                                          (torch.float32, "ur_attention_stream")])
def test_stream_launch_takes_the_entry_of_its_dtype(cuda, monkeypatch, dtype, symbol):
    kern = K.streaming_attention_bh_prescaled
    assert _launch_takes(monkeypatch, kern, (1, 1024, 512), 512, dtype) == [symbol]


@pytest.mark.parametrize("shape", [(2, 2048, 256), (1, 1024, 384), (1, 1024, 512),
                                   (8, 4096, 512), (4, 4096, 512), (1, 6144, 512)])
def test_stream_sm90_matches_the_mma_sync_kernel(cuda, shape):
    """At every width, and at the restore's and the server's shapes."""
    q, k, v = _qkv(shape, shape[-1], torch.bfloat16, seed=2)
    out = K.streaming_attention_bh_prescaled(q, k, v)
    prev = chip_smoke.direct(K.library().ur_attention_stream, q, k, v)
    torch.cuda.synchronize()
    assert K.bf16_tolerance_ratio(out, prev) <= 1.0


@pytest.mark.parametrize("d,t", [(64, 256), (64, 264), (128, 256), (128, 328)])
def test_bh_sm90_selects_exact_rows(cuda, d, t):
    """In each of two heads, each query's logits put one key (a permutation of
    all T: every key tile, every row of each 128-byte swizzle atom, every ring
    stage) at logit 0 and every other at -160 or below, so exp2 of the others
    is 0 in fp32 and every output column must equal the selected V row bit for
    bit. The zero rows TMA fills in past T would also score 0: unless the
    kernel masks them, a row of a T that is not a multiple of 64 mixes the
    selected V row with zeros. A wrong K descriptor picks another key; a wrong
    V descriptor, swizzle or transpose bit permutes or mixes V's columns; a
    wrong head offset reads another head's keys; a query row at or past T
    stored writes past the output's end (a guard region must stay as it
    was)."""
    rng = np.random.default_rng(d + t)
    bh, scale = 2, 512 // d
    # +-1 codes in d - 1 columns and a last column of 1 in k, -(d - 1) in q:
    # q_i . k_j = scale * ((d - 1 - 2 dist(i, j)) - (d - 1)) = -2 scale dist
    codes = rng.choice([-1.0, 1.0], size=(bh, t, d - 1))
    for c in codes:
        dist = (d - 1 - c @ c.T) / 2
        np.fill_diagonal(dist, d)
        assert 2 * scale * dist.min() >= 160
    perms = [rng.permutation(t) for _ in range(bh)]
    q = scale * np.concatenate([np.stack([c[p] for c, p in zip(codes, perms)]),
                                np.full((bh, t, 1), -(d - 1.0))], -1)
    k = np.concatenate([codes, np.ones((bh, t, 1))], -1)
    q, k = (torch.tensor(x, dtype=torch.bfloat16, device="cuda") for x in (q, k))
    v = torch.randn((bh, t, d), generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda").to(torch.bfloat16)
    kern = K.fused_attention_bh_prescaled
    assert kern.route(torch.bfloat16)[0] == "ur_attention_bh_sm90"
    out = kern(q, k, v)
    guarded = torch.full(((bh * t + 64) * d,), 7.0, dtype=torch.bfloat16, device="cuda")
    chip_smoke.direct(K.library_bh_sm90().ur_attention_bh_sm90, q, k, v,
                      guarded[:bh * t * d].view(bh, t, d))
    torch.cuda.synchronize()
    want = torch.stack([v[i, torch.from_numpy(p).cuda()] for i, p in enumerate(perms)])
    wrong = (out != want).any(-1).nonzero().tolist()
    assert not wrong, f"{len(wrong)} (head, row) pairs differ, first {wrong[:8]}"
    assert torch.equal(guarded[:bh * t * d].view(bh, t, d), want)
    assert bool((guarded[bh * t * d:] == 7.0).all()), "rows past T were stored"


@pytest.mark.parametrize("dtype,symbol", [(torch.bfloat16, "ur_attention_bh_sm90"),
                                          (torch.float32, "ur_attention_bh")])
def test_bh_launch_takes_the_entry_of_its_dtype(cuda, monkeypatch, dtype, symbol):
    kern = K.fused_attention_bh_prescaled
    assert _launch_takes(monkeypatch, kern, (3, 264, 64), 64, dtype) == [symbol]


@pytest.mark.parametrize("shape", [(160, 256, 64), (32, 256, 128), (80, 256, 64),
                                   (16, 256, 128), (20, 384, 64), (4, 384, 128),
                                   (2, 2056, 64), (2, 4096, 128)])
def test_bh_sm90_matches_the_mma_sync_kernel(cuda, shape):
    """At the restore's and the server's shapes, and at two long rows (the
    ring reloads its stages; T = 2056 masks the last tile)."""
    q, k, v = _qkv(shape, shape[-1], torch.bfloat16, seed=2)
    out = K.fused_attention_bh_prescaled(q, k, v)
    prev = chip_smoke.direct(K.library().ur_attention_bh, q, k, v)
    torch.cuda.synchronize()
    assert K.bf16_tolerance_ratio(out, prev) <= 1.0


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
    with pytest.raises(ValueError, match="CUDA device"):
        kern(q, k.cpu(), v)


def _rms_rel(a, b):
    return ((a.float() - b.float()).square().mean().sqrt() / b.float().square().mean().sqrt()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,shape,d", [
    ("btc", (2, 4096, 128), 64),   # T > 1024: the backward recomputes 512-query chunks
    ("bh", (3, 264, 64), 64),
    ("stream", (1, 1024, 512), 512),
])
def test_kernel_gradient_matches_plain_autograd(cuda, dtype, name, shape, d):
    kern = {"btc": K.fused_attention_btc_prescaled, "bh": K.fused_attention_bh_prescaled,
            "stream": K.streaming_attention_bh_prescaled}[name]
    q, k, v = _qkv(shape, d, dtype, seed=3)
    g = torch.randn(shape, generator=torch.Generator(device="cuda").manual_seed(4),
                    device="cuda").to(dtype)

    def grads(fn):
        xs = [x.detach().requires_grad_() for x in (q, k, v)]
        return torch.autograd.grad(fn(*xs), xs, g)

    launches, backwards = kern.launches, kern.backwards
    ours = grads(kern)
    torch.cuda.synchronize()
    assert (kern.launches, kern.backwards) == (launches + 1, backwards + 1)
    for a, b in zip(ours, grads(kern.plain)):
        if dtype == torch.bfloat16:
            assert _rms_rel(a, b) <= 2.0 ** -6
        else:
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


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


def _gconv_inputs(shape, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[-1]
    cg = c // 16
    x = torch.randn(shape, generator=g, device="cuda").to(dtype)
    w = (torch.randn((c, cg, 3, 3), generator=g, device="cuda") * (9 * cg) ** -0.5).to(dtype)
    b = (torch.randn((c,), generator=g, device="cuda") * 0.1).to(dtype)
    return x, w.contiguous(memory_format=torch.channels_last), b


@pytest.fixture
def no_tf32():
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's einsum in fp32
    yield
    torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (8, 256, 256, 512), (8, 128, 128, 1024), (8, 64, 64, 2048),  # the 512 px main path
    (2, 37, 45, 256),   # ragged H and W against the 4 x 32 tiles, cg = 16
])
def test_grouped_conv_matches_plain(cuda, no_tf32, dtype, shape):
    x, w, b = _gconv_inputs(shape, dtype)
    before = G.grouped_conv3.launches
    out = G.grouped_conv3(x, w, b, 16)
    torch.cuda.synchronize()
    assert G.grouped_conv3.launches == before + 1
    ref = G.grouped_conv3_plain(x, w, b, 16)
    if dtype == torch.bfloat16:
        assert G.bf16_tolerance_ratio(out, ref) <= 1.0
    else:
        torch.testing.assert_close(out, ref, **FP32_TOL)


@pytest.mark.parametrize("shape", [(2, 37, 45, 256), (2, 21, 35, 512), (1, 19, 33, 1024),
                                   (1, 13, 17, 2048)])
def test_gconv_sm90_selects_exact_inputs(cuda, shape):
    """Each output channel o of group g takes one input channel of its group
    (c(g, o)) at one tap (t(g, o), every tap and every 16-byte chunk of the
    swizzled rows in turn) with weight 1 and bias 0, so the output must equal
    the shifted input bit for bit, with zeros where the tap reaches outside
    the map. A wrong tensor map, swizzle, B descriptor, per-group weight
    offset, halo origin or edge mask moves or mixes values. cg = 16 / 32 /
    64 / 128, H and W ragged against the 8 x 16 tiles; the direct call writes
    into a buffer with a guard region past its end, which must stay as it
    was."""
    bsz, h, wd, c = shape
    cg = c // 16
    x = torch.randn(shape, generator=torch.Generator(device="cuda").manual_seed(cg),
                    device="cuda").to(torch.bfloat16)
    w = torch.zeros((c, cg, 3, 3), device="cuda", dtype=torch.bfloat16)
    want = torch.empty_like(x)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    for g in range(16):
        for o in range(cg):
            tap, ci = (o + 2 * g) % 9, (5 * o + 3 * g) % cg
            dy, dx = divmod(tap, 3)
            w[g * cg + o, ci, dy, dx] = 1.0
            want[..., g * cg + o] = xp[:, dy:dy + h, dx:dx + wd, g * cg + ci]
    b = torch.zeros((c,), device="cuda", dtype=torch.bfloat16)
    assert G.grouped_conv3.route(torch.bfloat16)[0] == "ur_grouped_conv3_sm90"
    out = G.grouped_conv3(x, w, b, 16)
    guarded = torch.full((x.numel() + 4096,), 7.0, dtype=torch.bfloat16, device="cuda")
    chip_smoke.direct_gconv(G.library_sm90().ur_grouped_conv3_sm90, x, G.pack_weights(w, 16),
                            b, guarded[:x.numel()].view(shape))
    torch.cuda.synchronize()
    wrong = (out != want).nonzero()
    assert not len(wrong), f"{len(wrong)} values differ, first {wrong[:8].tolist()}"
    assert torch.equal(guarded[:x.numel()].view(shape), want)
    assert bool((guarded[x.numel():] == 7.0).all()), "stored past the output's end"


@pytest.mark.parametrize("dtype,symbol", [(torch.bfloat16, "ur_grouped_conv3_sm90"),
                                          (torch.float32, "ur_grouped_conv3")])
def test_gconv_launch_takes_the_entry_of_its_dtype(cuda, monkeypatch, dtype, symbol):
    kern, chosen, route = G.grouped_conv3, [], G.grouped_conv3.route

    def spy(dt):
        chosen.append(route(dt)[0])
        return route(dt)

    monkeypatch.setattr(kern, "route", spy)
    x, w, b = _gconv_inputs((2, 37, 45, 512), dtype)
    before = kern.launches
    kern(x, w, b, 16)
    torch.cuda.synchronize()
    assert kern.launches == before + 1 and chosen == [symbol]


@pytest.mark.parametrize("shape", chip_smoke.gconv_shapes())
def test_gconv_sm90_matches_the_mma_sync_kernel(cuda, shape):
    """At every phase-3 shape: the restore's, the server's batch of four
    tiles, and a 256 x 384 image restored whole."""
    x, w, b = _gconv_inputs(shape, torch.bfloat16, seed=2)
    out = G.grouped_conv3(x, w, b, 16)
    prev = chip_smoke.direct_gconv(G.library().ur_grouped_conv3, x, G.pack_weights(w, 16), b)
    torch.cuda.synchronize()
    assert G.bf16_tolerance_ratio(out, prev) <= 1.0


def test_grouped_conv_gradient_matches_plain_autograd(cuda, no_tf32):
    x, w, b = _gconv_inputs((2, 32, 48, 1024), torch.float32, seed=1)
    gy = torch.randn(x.shape, generator=torch.Generator(device="cuda").manual_seed(2),
                     device="cuda")

    def grads(fn):
        xs = [t.detach().requires_grad_() for t in (x, w, b)]
        return torch.autograd.grad(fn(*xs, 16), xs, gy)

    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the backward's convolutions in fp32
    try:
        ours, ref = grads(G.grouped_conv3), grads(G.grouped_conv3_plain)
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    # the weight gradient sums B*H*W = 3072 products per entry, in cuDNN's
    # order against the einsum's: 1e-4 of each gradient's largest entry
    for a, r in zip(ours, ref):
        torch.testing.assert_close(a, r, atol=1e-4 * r.abs().max().item(), rtol=1e-4)


def test_grouped_conv_wrapper_raises_on_what_it_cannot_run(cuda):
    x, w, b = _gconv_inputs((1, 8, 8, 512), torch.float32)
    with pytest.raises(TypeError):
        G.grouped_conv3(x.half(), w.half(), b.half(), 16)
    with pytest.raises(ValueError, match="unsupported"):
        G.grouped_conv3(x[..., :320].contiguous(), w[:320, :20].contiguous(), None, 16)
    with pytest.raises(ValueError, match="CUDA device"):
        G.grouped_conv3(x, w.cpu(), b, 16)


# ---------------------------------------------------------------------------
# the out-projection-fused kernel (ur_attention_btc_out)
# ---------------------------------------------------------------------------


def _qkvw(shape, c_out, dtype, seed=0):
    q, k, v = _qkv(shape, 64, dtype, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    wo = torch.randn((shape[-1], c_out), generator=g, device="cuda") * shape[-1] ** -0.5
    return q, k, v, wo.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,c_out", [
    ((2, 1024, 128), 128),
    ((2, 1024, 320), 320),     # UNet level 0 widths
    ((1, 1536, 640), 640),     # UNet level 1 of a 512 x 768 restore
    ((1, 1024, 1280), 1280),   # UNet level 2 of an untiled 1024 px restore: the largest O tile
    ((2, 1024, 256), 256),     # Controller stage 1
    ((4, 1024, 640), 640),     # the server's batch of four tiles, UNet level 1
    ((1, 6144, 320), 320),     # a 256 x 384 image whole at 512 x 768, UNet level 0
])
def test_btc_out_matches_plain(cuda, no_tf32, dtype, shape, c_out):
    kern = K.fused_attention_btc_out_prescaled
    xs = _qkvw(shape, c_out, dtype)
    before = kern.launches
    out = kern(*xs)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert out.shape == (*shape[:2], c_out) and out.dtype == dtype
    ref = kern.plain(*xs)
    if dtype == torch.bfloat16:
        assert K.bf16_out_tolerance_ratio(out, ref) <= 1.0
    else:
        torch.testing.assert_close(out, ref, atol=1e-5 * ref.abs().max().item(), rtol=1e-5)


@pytest.mark.parametrize("heads", [4, 5, 10, 20])
def test_btc_out_sm90_selects_exact_outputs(cuda, heads):
    """In each head, each query's logits put one key (a per-head permutation
    of all 1024) at least 160 above every other, so each head's output is the
    selected V row exactly; ``wo`` is a 0/1 matrix whose output column c
    copies inner channel ``src[c]`` (a permutation), so every output must
    equal one V entry bit for bit. At H = 4 / 5 / 10 / 20 the cluster has 4 /
    5 / 5 / 7 CTAs (H = 20 splits heads and column chunks unevenly; H = 10
    takes two chunks a pass): a wrong peer slice, column share, head slot,
    descriptor or wo tile picks another entry."""
    rng = np.random.default_rng(heads)
    batch, t, d = 2, 1024, 64
    inner = heads * d
    q = np.empty((t, inner), np.float32)
    k = np.empty((t, inner), np.float32)
    perms = []
    for h in range(heads):
        codes = rng.choice([-1.0, 1.0], size=(t, d))
        dist = (d - codes @ codes.T) / 2  # q_i . k_j = 8 (64 - 2 dist)
        np.fill_diagonal(dist, d)
        assert dist.min() >= 10
        perms.append(rng.permutation(t))
        q[:, h * d:(h + 1) * d] = 8.0 * codes[perms[-1]]
        k[:, h * d:(h + 1) * d] = codes
    src = rng.permutation(inner)
    wo = np.zeros((inner, inner), np.float32)
    wo[src, np.arange(inner)] = 1.0
    dev = dict(dtype=torch.bfloat16, device="cuda")
    qt, kt = (torch.tensor(x, **dev)[None].expand(batch, t, inner).contiguous() for x in (q, k))
    v = torch.randn((batch, t, inner), generator=torch.Generator(device="cuda").manual_seed(3),
                    device="cuda").to(torch.bfloat16)
    kern = K.fused_attention_btc_out_prescaled
    assert kern.route(torch.bfloat16)[0] == "ur_attention_btc_out_sm90"
    out = kern(qt, kt, v, torch.tensor(wo, **dev))
    torch.cuda.synchronize()
    rows = torch.tensor(np.stack(perms, 1), device="cuda")  # (t, H): the key each query picks
    o = torch.cat([v[:, rows[:, h], h * d:(h + 1) * d] for h in range(heads)], -1)
    want = o[..., torch.from_numpy(src).cuda()]
    wrong = (out != want).any(-1).nonzero().tolist()
    assert not wrong, f"{len(wrong)} (batch, row) pairs differ, first {wrong[:8]}"


@pytest.mark.parametrize("dtype,symbol", [(torch.bfloat16, "ur_attention_btc_out_sm90"),
                                          (torch.float32, "ur_attention_btc_out")])
def test_btc_out_launch_takes_the_entry_of_its_dtype(cuda, monkeypatch, dtype, symbol):
    kern = K.fused_attention_btc_out_prescaled
    chosen, route = [], kern.route

    def spy(dt):
        chosen.append(route(dt)[0])
        return route(dt)

    monkeypatch.setattr(kern, "route", spy)
    xs = _qkvw((1, 1024, 320), 320, dtype)
    before = kern.launches
    kern(*xs)
    torch.cuda.synchronize()
    assert kern.launches == before + 1 and chosen == [symbol]


@pytest.mark.parametrize("shape", [(8, 1024, 640), (1, 1536, 640), (2, 1024, 1280),
                                   (1, 4096, 256), (2, 1024, 128)])
def test_btc_out_sm90_matches_the_mma_sync_kernel(cuda, shape):
    xs = _qkvw(shape, shape[-1], torch.bfloat16, seed=4)
    out = K.fused_attention_btc_out_prescaled(*xs)
    prev = chip_smoke.direct(K.library().ur_attention_btc_out, *xs[:3], wo=xs[3])
    torch.cuda.synchronize()
    assert K.bf16_out_tolerance_ratio(out, prev) <= 1.0


def test_btc_out_wrapper_raises_on_what_it_cannot_run(cuda):
    kern = K.fused_attention_btc_out_prescaled
    q, k, v, wo = _qkvw((1, 1024, 128), 128, torch.float32)
    with pytest.raises(TypeError):
        kern(q, k, v, wo.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        kern(q, k, v, wo.t().contiguous().t())
    shifted = torch.empty(wo.numel() + 1, device="cuda")[1:].view(wo.shape)  # 4 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        kern(q, k, v, shifted)
    with pytest.raises(ValueError, match="unsupported"):
        kern(q, k, v, wo[:, :96].contiguous())
    with pytest.raises(ValueError, match="CUDA device"):
        kern(q, k, v, wo.cpu())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_btc_out_gradient_matches_plain_autograd(cuda, no_tf32, dtype):
    """dq, dk, dv and dwo; T = 4096 > 1024, so the backward recomputes 512-query chunks."""
    kern = K.fused_attention_btc_out_prescaled
    xs0 = _qkvw((2, 4096, 128), 128, dtype, seed=5)
    g = torch.randn((2, 4096, 128), generator=torch.Generator(device="cuda").manual_seed(7),
                    device="cuda").to(dtype)

    def grads(fn):
        xs = [x.detach().requires_grad_() for x in xs0]
        return torch.autograd.grad(fn(*xs), xs, g)

    launches, backwards = kern.launches, kern.backwards
    ours = grads(kern)
    torch.cuda.synchronize()
    assert (kern.launches, kern.backwards) == (launches + 1, backwards + 1)
    for a, b in zip(ours, grads(kern.plain)):
        assert a.shape == b.shape
        if dtype == torch.bfloat16:
            assert _rms_rel(a, b) <= 2.0 ** -6
        else:
            torch.testing.assert_close(a, b, atol=1e-4 * b.abs().max().item(), rtol=1e-4)


def test_mha_fused_out_on_card_matches_cpu(cuda, no_tf32):
    """The fused route (bias added after the kernel) on the card == the CPU."""
    g = torch.Generator().manual_seed(1)
    p = {name: {"w": torch.randn(128, 128, generator=g) * 128 ** -0.5,
                "b": torch.randn(128, generator=g) * 0.1}
         for name in ("to_q", "to_k", "to_v", "to_out")}
    x = torch.randn(2, 1024, 128, generator=g)
    with TA.fused_out_projection(True):
        cpu = TA.mha(p, x, heads=2)
        p_cuda = {n: {k: v.cuda() for k, v in pp.items()} for n, pp in p.items()}
        before = K.fused_attention_btc_out_prescaled.launches
        out = TA.mha(p_cuda, x.cuda(), heads=2)
    assert K.fused_attention_btc_out_prescaled.launches == before + 1
    torch.testing.assert_close(out.cpu(), cpu, **FP32_TOL)


@pytest.mark.parametrize("mode", ["none", "deep"])
def test_graphed_restore_matches_the_eager_restore(cuda, no_tf32, mode):
    """The tiny restore (fp32, 128 px, batch 2, 3 steps) replayed from a CUDA
    graph against the eager restore on the same inputs and noise, within
    fp32's 1e-5 (the same kernels; cuDNN may pick other algorithms under
    capture). Two replays agree bit for bit. With one graph allowed, a
    second task evicts the first, which is captured again when it returns."""
    import dataclasses

    from unirestore_torch import graphs as GR
    from unirestore_torch.models import unirestore as UR

    cfg = dataclasses.replace(UR.tiny_config(), cache_mode=mode, cache_stride=2)
    frozen, trainable = UR.init(cfg, device="cuda", seed=3)
    sched = UR.schedule(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    images = torch.rand((2, 128, 128, 3), generator=gen, device="cuda")
    post, diff = UR.restore_noise(cfg, images.shape, images.dtype, gen, cuda)
    noise = dict(posterior_noise=post, diffusion_noise=diff)
    graphed = GR.GraphedRestore(frozen, trainable, cfg, sched, device=cuda, max_graphs=1)
    first = graphed(images, "ir", None, 3, **noise)
    second = graphed(images, "ir", None, 3, **noise)
    eager = UR.restore(frozen, trainable, cfg, sched, images, "ir", None, 3, device=cuda, **noise)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.isfinite(first).all()
    torch.testing.assert_close(first, eager, **FP32_TOL)
    (key,) = graphed.stats
    assert (graphed.stats[key].captures, graphed.stats[key].replays) == (1, 2)
    graphed(images, "cls", None, 3, **noise)  # evicts the "ir" graph
    again = graphed(images, "ir", None, 3, **noise)
    torch.cuda.synchronize()
    assert graphed.stats[key].captures == 2 and torch.equal(again, first)


def test_device_prefetch_copies_without_a_host_wait(cuda):
    """``data.loader.device_prefetch``: batches copied on a side stream land
    before the consumer reads them, and nothing in the loop waits for the card."""
    from unirestore_torch.data import loader as TDL

    rng = np.random.default_rng(0)
    batches = [{"hq": rng.uniform(size=(2, 256, 256, 3)).astype(np.float32), "task": "ir"}
               for _ in range(6)]
    got = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in TDL.device_prefetch(batches, cuda, depth=2):
            got.append(b["hq"] * 2.0)  # the consumer's work on the current stream
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for g, b in zip(got, batches):
        assert g.device.type == "cuda" and b["task"] == "ir"
        assert torch.equal(g.cpu(), torch.from_numpy(b["hq"]) * 2.0)


def _state_of(trainable, opt_state, stage):
    from unirestore_torch.train import steps as TS

    out = {f"trainable/{k}": v.clone() for k, v in TS.trained_leaves(stage, trainable).items()}
    for name, sub in opt_state.items():
        if isinstance(sub, dict):
            out.update({f"{name}/{k}": v.clone() for k, v in sub.items()})
        else:
            out[name] = sub
    return out


def test_graphed_train_step_matches_the_eager_step(cuda, no_tf32):
    """The tiny stage-1 step (fp32, 128 px, batch 2; AdamW at accumulation 2
    with a clip that triggers) replayed from CUDA graphs against
    ``make_train_step`` from one state, over an accumulating and an applying
    micro-step: every log, trained leaf and optimizer slot bit-equal. A
    rebound trainable tree is refused."""
    from unirestore_torch import bridge
    from unirestore_torch import graphs as GR
    from unirestore_torch.models import unirestore as UR
    from unirestore_torch.train import optim as OPT
    from unirestore_torch.train import steps as TS

    cfg = UR.tiny_config()
    frozen, trainable = UR.init(cfg, device="cuda", seed=5)
    sched = UR.schedule(cfg, device="cuda")
    stage = TS.StageConfig(train_cfrm=True, train_cnet=True)
    gen = torch.Generator(device="cuda").manual_seed(6)
    inputs = []
    for _ in range(2):
        batch = {k: torch.rand((2, 128, 128, 3), generator=gen, device="cuda")
                 for k in ("lq", "hq")}
        inputs.append((batch, TS.draw_noise(cfg, batch, gen)))
    out = {}
    for route in ("eager", "graph"):
        tx = OPT.AdamW(1e-3, eps=1e-3, accum_iter=2, grad_clip=1e-3)
        tr = bridge.unflatten_like({k: v.clone() for k, v in bridge.flatten(trainable).items()},
                                   trainable)
        state = tx.init(TS.trained_leaves(stage, tr))
        if route == "eager":
            step = TS.make_train_step(frozen, cfg, sched, stage, tx, "ir")
        else:
            step = GR.GraphedTrainStep(frozen, cfg, sched, stage, tx, "ir", device=cuda)
        logs = [{k: v.item() for k, v in step(tr, state, *x)[2].items()} for x in inputs]
        out[route] = (logs, _state_of(tr, state, stage), step, tx)
    assert out["eager"][0] == out["graph"][0]
    for k, v in out["eager"][1].items():
        same = torch.equal(v, out["graph"][1][k]) if isinstance(v, torch.Tensor) else \
            v == out["graph"][1][k]
        assert same, k
    graphed, tx = out["graph"][2], out["graph"][3]
    (stats,) = graphed.stats.values()
    assert (stats.captures, stats.replays) == (1, 2)
    other = bridge.unflatten_like({k: v.clone() for k, v in bridge.flatten(trainable).items()},
                                  trainable)
    with pytest.raises(ValueError, match="not the one captured"):
        graphed(other, tx.init(TS.trained_leaves(stage, other)), *inputs[0])


@pytest.mark.parametrize("name", chip_smoke.OPT_NAMES)
def test_optimizer_device_scalars_match_host_floats_on_the_card(cuda, name):
    """Each optimizer's update with its per-update scalars in a
    ``graphs.ScalarBuffer`` on the card against the host floats, over seven
    calls at accumulation 3 with a clip that triggers: bit-equal (a divisor
    is applied as PyTorch applies a host scalar on a CUDA tensor, by its fp32
    reciprocal)."""
    from unirestore_torch import graphs as GR
    from unirestore_torch.train import optim as OPT

    final = {}
    for route in ("host", "device"):
        tx = OPT.make_optimizer(name, lr=OPT.make_lr_schedule("onecycle", 1e-2, 12),
                                weight_decay=0.1, accum_iter=3, grad_clip=0.5)
        gen = torch.Generator(device="cuda").manual_seed(1)
        params = {k: 0.5 * torch.randn(s, device="cuda", generator=gen)
                  for k, s in chip_smoke.OPT_SHAPES.items()}
        state = tx.init(params)
        for _ in range(7):
            grads = {k: torch.randn(v.shape, device="cuda", generator=gen)
                     for k, v in params.items()}
            if route == "host":
                tx.update(state, params, grads)
                continue
            applies, host = tx.advance(state)
            buf = GR.ScalarBuffer(host, cuda)
            buf.fill(host)
            tx.apply(state, params, grads, applies, buf.views)
        final[route] = {**params, **{f"{n}/{k}": t for n, sub in state.items()
                                     if isinstance(sub, dict) for k, t in sub.items()}}
    for k, v in final["host"].items():
        assert torch.equal(v, final["device"][k]), k
