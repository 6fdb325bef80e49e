"""Port parity: the three attention kernels' plain versions, the routing, and ``mha``.

The plain versions are held against the Pallas kernels run in interpret mode
(as tests/test_nn.py runs them), on prescaled q. Tolerances:

- plain vs Pallas (both exp2 on the same prescaled q, fp32): 1e-5. The
  Pallas stream kernel's online softmax rescales partial sums, which moves
  the last bits only.
- ``mha`` / ``spatial_self_attention`` vs JAX on the CPU: 1e-5. JAX takes
  the XLA path there (natural-exp softmax, unscaled q), the port the kernel
  routes' plain versions (base-2 softmax on q prescaled by scale*log2(e)
  folded into the weights); exp(x) vs exp2(x*log2 e) differ by a few ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bridge import jax_params, nhwc, port_params, to_np
from unirestore_torch.nn import attention as TA
from unirestore_torch.nn import attention_kernels as K
from unirestore_tpu.nn import attention as JA
from unirestore_tpu.nn import pallas_attention as PA

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(seed, shape, d):
    q, k, v = (nhwc(seed + i, *shape) for i in range(3))
    return q * np.float32(d ** -0.5 * PA._LOG2E), k, v


@pytest.mark.parametrize("kind,shape", [
    ("btc", (2, 256, 2 * 64)),
    ("bh", (4, 256, 64)),
    ("bh", (4, 256, 128)),
    ("stream", (1, 1024, 256)),
])
def test_plain_kernels_match_pallas_interpret(kind, shape):
    d = 64 if kind == "btc" else shape[-1]
    q, k, v = _qkv(10, shape, d)
    qj, kj, vj = map(jnp.asarray, (q, k, v))
    if kind == "btc":
        ref = PA._fused_raw_btc(qj, kj, vj, 64, interpret=True)
        out = K.attention_btc_plain(*map(torch.from_numpy, (q, k, v)))
        wrapped = K.fused_attention_btc_prescaled
    elif kind == "bh":
        ref = PA._fused_raw_bh(qj, kj, vj, PA._LN2, interpret=True, prescaled=True)
        out = K.attention_bh_plain(*map(torch.from_numpy, (q, k, v)))
        wrapped = K.fused_attention_bh_prescaled
    else:
        ref = PA._streaming_raw_bh(qj, kj, vj, PA._LN2, interpret=True, prescaled=True)
        out = K.attention_bh_plain(*map(torch.from_numpy, (q, k, v)))
        wrapped = K.streaming_attention_bh_prescaled
    np.testing.assert_allclose(to_np(out), np.asarray(ref), **TOL)
    # the wrapper on CPU tensors is the plain version and launches nothing
    before = wrapped.launches
    np.testing.assert_array_equal(to_np(wrapped(*map(torch.from_numpy, (q, k, v)))),
                                  to_np(out))
    assert wrapped.launches == before == 0


# every main-path shape (512 px: 64x64 latent) plus edges of each predicate
_T = [64, 77, 256, 264, 512, 1024, 1280, 2048, 4096, 16384]
_D = [32, 64, 96, 128, 192, 256, 384, 512, 640]


def test_routing_predicates_match_jax():
    for t in _T:
        for s in (t, 77):
            for d in _D:
                assert K.supported(t, s, d) == PA.supported(t, s, d), (t, s, d)
                assert K.stream_supported(t, s, d) == PA.stream_supported(t, s, d)
                for inner in (d, 2 * d, 5 * d, 320, 640, 1280):
                    assert (K.btc_supported(t, s, inner, d)
                            == PA.btc_supported(t, s, inner, d)), (t, s, inner, d)


@pytest.mark.parametrize("t,dim,heads,ctx", [
    (1024, 128, 2, None),    # channel-flat kernel route (d=64)
    (256, 128, 2, None),     # head-major route, d=64
    (256, 256, 2, None),     # head-major route, d=128
    (1024, 256, 1, None),    # streaming route, d=256
    (64, 64, 2, None),       # plain: short sequence
    (256, 128, 2, 77),       # plain: cross-attention over 77 tokens
])
def test_mha_matches_jax(t, dim, heads, ctx):
    cdim = 48 if ctx else None
    pj = jax_params(JA.mha_init, dim, heads, dim // heads, cdim, ctx is None)
    pt = port_params(pj, TA.mha_init, dim, heads, dim // heads, cdim, ctx is None)
    x = nhwc(20, 2, t, dim)
    c = nhwc(21, 2, ctx, cdim) if ctx else None
    ref = JA.mha(pj, jnp.asarray(x), None if c is None else jnp.asarray(c), heads=heads)
    out = TA.mha(pt, torch.from_numpy(x), None if c is None else torch.from_numpy(c),
                 heads=heads)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), **TOL)
    assert all(kern.launches == 0 for kern in K.KERNELS)


def test_spatial_self_attention_matches_jax():
    pj = jax_params(JA.spatial_self_attention_init, 64, 1)
    pt = port_params(pj, TA.spatial_self_attention_init, 64, 1)
    x = nhwc(22, 1, 32, 32, 64)
    ref = JA.spatial_self_attention(pj, jnp.asarray(x), heads=1, groups=8)
    out = TA.spatial_self_attention(pt, torch.from_numpy(x), heads=1, groups=8)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), **TOL)


@pytest.mark.parametrize("b,heads", [(1, 4), (2, 4), (3, 1)])
def test_head_major_inputs_are_contiguous(b, heads):
    """The CUDA wrappers take only contiguous tensors; a batch of one made the
    head-major reshape return a strided view."""
    y = torch.arange(b * 8 * heads * 4, dtype=torch.float32).reshape(b, 8, heads * 4)
    hm = TA._head_major(y, heads)
    assert hm.is_contiguous() and hm.shape == (b * heads, 8, 4)
    torch.testing.assert_close(hm.reshape(b, heads, 8, 4).transpose(1, 2).reshape(y.shape), y)


def test_kernel_wrapper_rejects_what_it_cannot_run():
    """Shape checks run before any build or launch; meta tensors stand in for the card."""
    q = torch.empty(2, 300, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        K.fused_attention_bh_prescaled(q, q, q)
    with pytest.raises(ValueError, match="unsupported"):
        K._btc_dims(torch.empty(2, 1000, 128))
    with pytest.raises(ValueError, match="unsupported"):
        K._stream_dims(torch.empty(1, 4096, 64))


def _online_attention(q, k, v, fault):
    """The bf16 kernels' arithmetic in plain torch, with one of the faults planted.

    64-key tiles, fp32 running max and row sum, probabilities rounded to bf16
    before the PV product, as in ``csrc/attention.cu``.
    """
    m = torch.full(q.shape[:-1] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape[:-1] + v.shape[-1:])
    t = k.shape[1] - (64 if fault == "last_key_tile_dropped" else 0)
    for k0 in range(0, t, 64):
        s = q.float() @ k[:, k0:k0 + 64].float().transpose(1, 2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = (l if fault == "row_sum_not_rescaled" else l * corr) + p.sum(-1, keepdim=True)
        acc = acc if fault == "accumulator_not_rescaled" else acc * corr
        acc = acc + p.to(torch.bfloat16).float() @ v[:, k0:k0 + 64].float()
        m = m_new
    return (acc / l).to(torch.bfloat16)


@pytest.mark.parametrize("fault", ["none", "last_key_tile_dropped",
                                   "accumulator_not_rescaled", "row_sum_not_rescaled"])
@pytest.mark.parametrize("shape", [(1, 4096, 64), (1, 1024, 512)])
def test_bf16_tolerance_passes_tiled_arithmetic_and_rejects_faults(shape, fault):
    """chip_smoke.py holds each bf16 kernel to ``bf16_tolerance_ratio <= 1``: the
    kernels' own tiled arithmetic passes it, and each planted fault fails it."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(30, shape, shape[-1]))
    ref = K.attention_bh_plain(q, k, v)
    ratio = K.bf16_tolerance_ratio(_online_attention(q, k, v, fault), ref)
    assert (ratio <= 1.0) == (fault == "none"), ratio
    if fault == "none":
        bad = ref.clone()
        bad[0, 0, 0] = torch.nan
        assert K.bf16_tolerance_ratio(bad, ref) == float("inf")


# ---------------------------------------------------------------------------
# gradients: the wrappers' autograd functions (chunked recompute backward)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,shape", [("btc", (2, 256, 2 * 64)), ("bh", (4, 256, 64)),
                                        ("bh", (2, 192, 128))])
def test_chunked_backward_matches_jax_vjp(kind, shape):
    """The recompute backward over 64-query chunks (T = 192-256) == the VJP of
    ``_xla_reference_btc`` / ``_xla_reference_bh`` at scale ln 2, fp32, 1e-5."""
    d = 64 if kind == "btc" else shape[-1]
    q, k, v = _qkv(40, shape, d)
    g = nhwc(44, *shape)
    if kind == "btc":
        ref_fn = lambda a, b, c: PA._xla_reference_btc(a, b, c, PA._LN2, 64)  # noqa: E731
        ours = K.attention_btc_vjp
    else:
        ref_fn = lambda a, b, c: PA._xla_reference_bh(a, b, c, PA._LN2)  # noqa: E731
        ours = K.attention_vjp
    _, vjp = jax.vjp(ref_fn, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    got = ours(*map(torch.from_numpy, (q, k, v, g)), chunk=64)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(to_np(a), np.asarray(b), **TOL, err_msg=name)


def test_wrapper_gradient_is_the_recompute_backward():
    """A CPU tensor that requires grad goes through the autograd function: its
    backward is ``attention_vjp`` (counted in ``backwards``), not the plain
    version's autograd graph."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(50, (2, 256, 64), 64))
    g = torch.from_numpy(nhwc(51, 2, 256, 64))
    kern = K.fused_attention_bh_prescaled
    before = kern.backwards
    grads = torch.autograd.grad(kern(q, k, v), (q, k, v), g)
    assert kern.backwards == before + 1 and kern.launches == 0
    want = K.attention_vjp(q.detach(), k.detach(), v.detach(), g)
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_train_attn_chunk_matches_jax():
    with JA.force_xla_attention():
        for t in (64, 256, 1024, 1025, 1296, 2304, 4096, 4900, 16384):
            assert K.train_attn_chunk(t) == (JA._train_attn_chunk(t, t) or t), t


def test_attention_gradients_under_remat():
    """A rematerialised unit with a kernel route (T = 256, d = 64) gives the same
    gradients as without remat: the autograd function recomputes cleanly."""
    from unirestore_torch.nn import remat as TRM
    pj = jax_params(JA.mha_init, 128, 2, 64, None, True)
    pt = port_params(pj, TA.mha_init, 128, 2, 64, None, True)
    x = torch.from_numpy(nhwc(60, 2, 256, 128)).requires_grad_()
    leaves = [x, pt["to_q"]["w"].requires_grad_(), pt["to_k"]["w"].requires_grad_()]

    def loss(remat):
        y = TRM.checkpoint(TA.mha, pt, x, None, 2) if remat else TA.mha(pt, x, heads=2)
        return (y ** 2).sum()

    assert K.supported(256, 256, 64)
    plain = torch.autograd.grad(loss(False), leaves)
    before = K.fused_attention_bh_prescaled.backwards
    rematted = torch.autograd.grad(loss(True), leaves)
    assert K.fused_attention_bh_prescaled.backwards == before + 1
    for a, b in zip(rematted, plain):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
