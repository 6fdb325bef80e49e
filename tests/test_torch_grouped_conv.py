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

from test_torch_bridge import jax_params, port_params, to_np
from unirestore_torch.models import cfrm as TC
from unirestore_torch.nn import grouped_conv as G
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
