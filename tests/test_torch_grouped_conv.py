"""Port parity: the CFRM grouped 3x3 conv (plain version, gradient, routing).

The plain version is held against the Pallas kernel in interpret mode (both
variants, as tests/test_nn.py runs them) and against ``_xla_reference``; the
autograd function's backward against ``jax.grad`` through the kernel's custom
VJP. Tolerances as tests/test_nn.py states them for the same shapes: forward
atol/rtol 2e-4, gradients 2e-3 (fp32 sums over 9 * cg terms in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_bridge import jax_params, port_params, to_np
from unirestore_torch.models import cfrm as TC
from unirestore_torch.nn import grouped_conv as G
from unirestore_torch.nn import kernels as KN
from unirestore_tpu.models import cfrm as JC
from unirestore_tpu.nn.pallas_grouped_conv import _xla_reference, grouped_conv3_pallas

torch.set_num_threads(2)

SHAPES = [(2, 8, 16, 256, 16), (1, 8, 32, 128, 16), (2, 16, 16, 256, 2)]


def _inputs(b, h, w, c, g, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, h, w, c)) * 0.3).astype(np.float32)
    wk = (rng.normal(size=(3, 3, c // g, c)) * 0.05).astype(np.float32)  # HWIO
    return x, wk


def _oihw(wk):
    return torch.from_numpy(np.ascontiguousarray(wk.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret_and_xla(shape):
    *_, g = shape
    x, wk = _inputs(*shape)
    out = to_np(G.grouped_conv3(torch.from_numpy(x), _oihw(wk), None, g))
    np.testing.assert_allclose(out, np.asarray(_xla_reference(x, wk, g)), atol=2e-4, rtol=2e-4)
    for variant in ("v2", "v3"):
        ref = grouped_conv3_pallas(jnp.asarray(x), jnp.asarray(wk), g, True, variant)
        np.testing.assert_allclose(out, np.asarray(ref), atol=2e-4, rtol=2e-4, err_msg=variant)
    assert G.grouped_conv3.launches == 0  # CPU tensors run the plain version


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_matches_jax_custom_vjp(shape):
    *_, g = shape
    x, wk = _inputs(*shape, seed=1)
    gx, gw = jax.grad(lambda a, b: (grouped_conv3_pallas(a, b, g, True) ** 2).sum(),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(wk))
    xt, wt = torch.from_numpy(x).requires_grad_(), _oihw(wk).requires_grad_()
    before = G.grouped_conv3.backwards
    (G.grouped_conv3(xt, wt, None, g) ** 2).sum().backward()
    assert G.grouped_conv3.backwards == before + 1
    np.testing.assert_allclose(to_np(xt.grad), np.asarray(gx), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(to_np(wt.grad), np.asarray(gw).transpose(3, 2, 0, 1),
                               atol=2e-3, rtol=2e-3)


def test_bias_and_its_gradient_match_conv2d():
    """With a bias the function equals F.conv2d(groups) forward and backward."""
    x, wk = _inputs(2, 5, 7, 64, 16, seed=2)
    b = np.random.default_rng(3).normal(size=(64,)).astype(np.float32)
    args = [torch.from_numpy(x), _oihw(wk), torch.from_numpy(b)]
    ours = [a.clone().requires_grad_() for a in args]
    ref = [a.clone().requires_grad_() for a in args]
    out = G.grouped_conv3(*ours, 16)
    want = torch.nn.functional.conv2d(ref[0].permute(0, 3, 1, 2), ref[1], ref[2], padding=1,
                                      groups=16).permute(0, 2, 3, 1)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)
    gy = torch.randn(out.shape, generator=torch.Generator().manual_seed(4))
    out.backward(gy)
    want.backward(gy)
    for a, r in zip(ours, ref):
        torch.testing.assert_close(a.grad, r.grad, atol=1e-4, rtol=1e-4)


def test_supported_cases():
    """The CUDA kernel's own predicate (w OIHW): per-group widths 16/32/64/128,
    cin == cout; ragged H and W are masked in the kernel, so any size passes."""
    assert G.supported((8, 256, 256, 512), (512, 32, 3, 3), 16)
    assert G.supported((8, 128, 128, 1024), (1024, 64, 3, 3), 16)
    assert G.supported((8, 64, 64, 2048), (2048, 128, 3, 3), 16)
    assert G.supported((1, 32, 32, 2048), (2048, 128, 3, 3), 16)  # 256 px, batch 1
    assert G.supported((8, 250, 256, 512), (512, 32, 3, 3), 16)   # rows: masked
    assert not G.supported((8, 256, 256, 320), (320, 20, 3, 3), 16)  # cg 20
    assert not G.supported((8, 256, 256, 512), (256, 32, 3, 3), 16)  # cout
    assert not G.supported((2, 8, 8, 64), (64, 4, 3, 3), 16)  # tiny configs: cg 4
    assert not G.supported((8, 64, 64, 512), (512, 32, 1, 1), 16)  # 1x1


def test_packed_weight_layout():
    """The kernel reads w as (groups, 9, cg_out, cg_in): tap 3 dy + dx."""
    w = torch.arange(64 * 16 * 9, dtype=torch.float32).reshape(64, 16, 3, 3)
    wp = G.pack_weights(w.contiguous(memory_format=torch.channels_last), 4)
    assert wp.shape == (4, 9, 16, 16) and wp.is_contiguous()
    for g, dy, dx, o, i in [(0, 0, 0, 0, 0), (1, 2, 1, 3, 7), (3, 1, 2, 15, 15)]:
        assert wp[g, 3 * dy + dx, o, i] == w[g * 16 + o, i, dy, dx]


def test_wrapper_rejects_what_it_cannot_run():
    x = torch.empty(1, 4, 4, 512, device="meta")
    w = torch.empty(512, 32, 3, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        G.grouped_conv3.forward(x, w, None, 16)


@pytest.mark.parametrize("c", [128, 4])
def test_ada_naf_v2_matches_jax_with_gradients(c):
    """c = 128 routes the grouped 3x3 through the kernel's function (cg = 32);
    c = 4 (cg = 1) takes F.conv2d(groups=16)."""
    pj = jax_params(JC.ada_naf_v2_init, c)
    pt = port_params(pj, TC.ada_naf_v2_init, c)
    x = np.random.default_rng(5).normal(size=(2, 8, 8, c)).astype(np.float32)
    routed = G.supported((2, 8, 8, 4 * c), tuple(pt["group_conv"]["w"].shape), TC.GROUPS)
    assert routed == (c == 128)

    def loss_j(p, xx):
        return (JC.ada_naf_v2(p, xx) ** 2).mean()

    lj, (gpj, gxj) = jax.value_and_grad(loss_j, argnums=(0, 1))(pj, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    w = pt["group_conv"]["w"].requires_grad_()
    before = G.grouped_conv3.backwards
    lt = (TC.ada_naf_v2(pt, xt) ** 2).mean()
    gxt, gwt = torch.autograd.grad(lt, (xt, w))
    assert G.grouped_conv3.backwards == before + routed
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    np.testing.assert_allclose(to_np(gxt), np.asarray(gxj), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(to_np(gwt), np.asarray(gpj["group_conv"]["w"]).transpose(3, 2, 0, 1),
                               atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# the Hopper kernel ur_grouped_conv3_sm90 (bf16): routing, preconditions, and
# its arithmetic in plain torch against the tolerance the card holds it to
# ---------------------------------------------------------------------------


def test_gconv_routes_bf16_to_the_sm90_kernel():
    """bf16 launches take ``ur_grouped_conv3_sm90`` in its own source, fp32
    ones the FMA kernel ``ur_grouped_conv3``; ``build_all`` builds both."""
    kern = G.grouped_conv3
    assert kern.entry(torch.bfloat16) == ("ur_grouped_conv3_sm90", G.library_sm90,
                                          G.SOURCE_SM90)
    assert kern.entry(torch.float32) == ("ur_grouped_conv3", G.library, G.SOURCE)
    assert G.SOURCE_SM90.is_file() and G.SOURCE_SM90.parent == G.SOURCE.parent
    assert {G.SOURCE, G.SOURCE_SM90} <= set(KN.SOURCES)


@pytest.mark.parametrize("x_shape,w_shape,groups", [
    ((8, 256, 256, 512), (512, 32, 3, 3), 16),
    ((8, 128, 128, 1024), (1024, 64, 3, 3), 16),
    ((8, 64, 64, 2048), (2048, 128, 3, 3), 16),
    ((1, 32, 32, 2048), (2048, 128, 3, 3), 16),
    ((8, 250, 256, 512), (512, 32, 3, 3), 16),
    ((2, 37, 45, 256), (256, 16, 3, 3), 16),
    ((1, 5, 7, 32), (32, 16, 3, 3), 2),  # C not a multiple of the 64-channel box
])
def test_supported_shapes_meet_the_gconv_sm90_kernel_preconditions(x_shape, w_shape, groups):
    """Every shape ``supported`` admits meets what ``ur_grouped_conv3_sm90``
    checks and what its tensor maps need: a group width it was built for,
    byte strides that are multiples of 16 (below 2^40), boxes of at most 256
    per dimension whose channel row fits one 128-byte swizzle span."""
    assert G.supported(x_shape, w_shape, groups)
    b, h, w, c = x_shape
    cg = w_shape[1]
    assert cg in G.GROUP_WIDTHS and c % cg == 0
    th, tw = G.SM90_TILE
    dims, strides = (c, w, h, b), (2 * c, 2 * c * w, 2 * c * w * h)
    assert all(1 <= d < 2 ** 32 for d in dims)
    assert all(s % 16 == 0 and s < 2 ** 40 for s in strides)
    for box in [(G.SM90_BOX_C, tw + 2, th + 2, 1), (G.SM90_BOX_C, tw, th, 1)]:
        assert all(1 <= n <= 256 for n in box) and box[0] * 2 <= 128


def _gconv_sm90_model(x, w, b, fault):
    """``ur_grouped_conv3_sm90``'s arithmetic in plain torch, with one of its
    faults planted.

    Output tiles of ``G.SM90_TILE`` pixels, each over a halo box zero-filled
    outside the map (as TMA fills it); per 64-channel box, per tap, per
    16-channel k-step an fp32 product sum added to fp32 accumulators; the
    bias added in fp32; one rounding to bf16; the tiles' overhang past the map
    not stored. Faults: the last tap dropped, the halo box started one row
    low, each group taking the next group's weights, the bias skipped.
    """
    bsz, h, wd, c = x.shape
    cg = w.shape[1]
    groups = c // cg
    th, tw = G.SM90_TILE
    hp, wp = -(-h // th) * th, -(-wd // tw) * tw
    low = 1 if fault == "halo_row_off_by_one" else 0
    xf = F.pad(x.float(), (0, 0, 1, wp - wd + 1, 1, hp - h + 2))
    wg = w.float().reshape(groups, cg, cg, 3, 3)
    if fault == "wrong_group_weights":
        wg = wg.roll(-1, 0)
    acc = torch.zeros((bsz, hp, wp, groups, cg))
    for k0 in range(0, cg, G.SM90_BOX_C):
        for tap in range(8 if fault == "tap_dropped" else 9):
            dy, dx = divmod(tap, 3)
            xs = xf[:, dy + low:dy + low + hp, dx:dx + wp].reshape(bsz, hp, wp, groups, cg)
            for k in range(k0, min(cg, k0 + G.SM90_BOX_C), 16):
                acc += torch.einsum("bhwgi,goi->bhwgo", xs[..., k:k + 16],
                                    wg[:, :, k:k + 16, dy, dx])
    if fault != "bias_skipped":
        acc += b.float().reshape(groups, cg)
    return acc.reshape(bsz, hp, wp, c)[:, :h, :wd].to(torch.bfloat16)


@pytest.mark.parametrize("fault", ["none", "tap_dropped", "halo_row_off_by_one",
                                   "wrong_group_weights", "bias_skipped"])
@pytest.mark.parametrize("shape", [(1, 16, 40, 512), (1, 12, 20, 1024), (1, 8, 8, 2048),
                                   (2, 37, 45, 256)])
def test_bf16_tolerance_passes_the_gconv_sm90_arithmetic_and_rejects_faults(shape, fault):
    """``bf16_tolerance_ratio`` at the kernel's arithmetic (real channel
    widths, cg = 32 / 64 / 128 / 16, small maps, the last one ragged against
    the tiles): it passes, and each of the kernel's planted faults fails."""
    rng = np.random.default_rng(sum(shape))
    c = shape[-1]
    cg = c // 16
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.normal(size=(c, cg, 3, 3)) * (9 * cg) ** -0.5)
                         .astype(np.float32)).to(torch.bfloat16)
    b = torch.from_numpy((rng.normal(size=(c,)) * 0.1).astype(np.float32)).to(torch.bfloat16)
    ratio = G.bf16_tolerance_ratio(_gconv_sm90_model(x, w, b, fault),
                                   G.grouped_conv3_plain(x, w, b, 16))
    assert (ratio <= 1.0) == (fault == "none"), ratio
