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
- the out-projection-fused kernel: the same 1e-5 for its plain version and
  for ``mha`` on the fused route; its gradients within 1e-4 of each
  gradient's largest entry (dwo sums over T queries); the whole restore on
  the fused route 2e-4, as test_torch_pipeline.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from test_torch_bridge import jax_params, nhwc, port_params, to_np
from unirestore_torch.nn import attention as TA
from unirestore_torch.nn import attention_kernels as K
from unirestore_torch.nn import kernels as KN
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


def _online_attention(q, k, v, fault, block_k=64):
    """The bf16 kernels' arithmetic in plain torch, with one of the faults planted.

    ``block_k``-key tiles (64 in ``csrc/attention.cu``, 128 in
    ``csrc/attention_sm90.cu``), fp32 running max and row sum, probabilities
    rounded to bf16 before the PV product.
    """
    m = torch.full(q.shape[:-1] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape[:-1] + v.shape[-1:])
    t = k.shape[1] - (block_k if fault == "last_key_tile_dropped" else 0)
    for k0 in range(0, t, block_k):
        s = q.float() @ k[:, k0:k0 + block_k].float().transpose(1, 2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = (l if fault == "row_sum_not_rescaled" else l * corr) + p.sum(-1, keepdim=True)
        acc = acc if fault == "accumulator_not_rescaled" else acc * corr
        acc = acc + p.to(torch.bfloat16).float() @ v[:, k0:k0 + block_k].float()
        m = m_new
    return (acc / l).to(torch.bfloat16)


def _check_bf16_tolerance(shape, fault, block_k):
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(30, shape, shape[-1]))
    ref = K.attention_bh_plain(q, k, v)
    ratio = K.bf16_tolerance_ratio(_online_attention(q, k, v, fault, block_k), ref)
    assert (ratio <= 1.0) == (fault == "none"), ratio
    if fault == "none":
        bad = ref.clone()
        bad[0, 0, 0] = torch.nan
        assert K.bf16_tolerance_ratio(bad, ref) == float("inf")


_FAULTS = ["none", "last_key_tile_dropped", "accumulator_not_rescaled", "row_sum_not_rescaled"]


@pytest.mark.parametrize("fault", _FAULTS)
@pytest.mark.parametrize("shape", [(1, 4096, 64), (1, 1024, 512)])
def test_bf16_tolerance_passes_tiled_arithmetic_and_rejects_faults(shape, fault):
    """chip_smoke.py holds each bf16 kernel to ``bf16_tolerance_ratio <= 1``: the
    kernels' own tiled arithmetic (64-key tiles) passes it, and each planted
    fault fails it."""
    _check_bf16_tolerance(shape, fault, 64)


@pytest.mark.parametrize("fault", _FAULTS)
@pytest.mark.parametrize("shape", [(1, 4096, 64), (1, 1024, 64)])
def test_bf16_tolerance_passes_128_key_tiles_and_rejects_faults(shape, fault):
    """The same limit at ``ur_attention_btc_sm90``'s 128-key tiles: its arithmetic
    passes, and each fault fails, a dropped 128-key tile among them."""
    _check_bf16_tolerance(shape, fault, K.BTC_SM90_BLOCK)


@settings(max_examples=300, deadline=None, database=None)
@given(t=st.one_of(st.integers(0, 1 << 15), st.integers(0, 128).map(lambda n: 256 * n)),
       inner=st.one_of(st.integers(0, 4096), st.integers(0, 40).map(lambda n: 64 * n)))
def test_btc_supported_shapes_meet_the_sm90_kernel_preconditions(t, inner):
    """Every shape the channel-flat route admits takes ``ur_attention_btc_sm90``
    without masking: T a multiple of its 128-row blocks, whole 64-wide heads."""
    if K.btc_supported(t, t, inner, 64):
        assert t % K.BTC_SM90_BLOCK == 0 and t >= K.BTC_SM90_BLOCK and inner % 64 == 0
        assert K._btc_dims(torch.empty(2, t, inner, device="meta")) == (2, t, inner)


def test_btc_routes_bf16_to_the_sm90_kernel():
    """bf16 channel-flat launches take ``ur_attention_btc_sm90``, fp32 ones the
    FMA kernel ``ur_attention_btc``; of the other wrappers only the wide-head,
    head-major and out-projection-fused ones change entry."""
    kern = K.fused_attention_btc_prescaled
    assert kern.entry(torch.bfloat16) == ("ur_attention_btc_sm90", K.library_sm90, K.SOURCE_SM90)
    assert kern.entry(torch.float32) == ("ur_attention_btc", K.library, K.SOURCE)
    assert all(not other.symbols for other in K.KERNELS
               if other not in (kern, K.streaming_attention_bh_prescaled,
                                K.fused_attention_bh_prescaled,
                                K.fused_attention_btc_out_prescaled))
    assert K.SOURCE_SM90.is_file() and K.SOURCE_SM90.parent == K.SOURCE.parent


def test_stream_routes_bf16_to_the_sm90_kernel():
    """bf16 wide-head launches take ``ur_attention_stream_sm90`` in its own
    source, fp32 ones the FMA kernel ``ur_attention_stream``."""
    kern = K.streaming_attention_bh_prescaled
    assert kern.entry(torch.bfloat16) == ("ur_attention_stream_sm90", K.library_stream_sm90,
                                          K.SOURCE_STREAM_SM90)
    assert kern.entry(torch.float32) == ("ur_attention_stream", K.library, K.SOURCE)
    assert K.SOURCE_STREAM_SM90.is_file() and K.SOURCE_STREAM_SM90.parent == K.SOURCE.parent
    assert K.SOURCE_STREAM_SM90 in KN.SOURCES


@settings(max_examples=300, deadline=None, database=None)
@given(t=st.one_of(st.integers(0, 1 << 15), st.integers(0, 32).map(lambda n: 1024 * n)),
       d=st.one_of(st.integers(0, 1024), st.integers(0, 8).map(lambda n: 64 * n)))
def test_stream_supported_shapes_meet_the_sm90_kernel_preconditions(t, d):
    """Every shape the wide-head route admits takes ``ur_attention_stream_sm90``
    without masking: T a multiple of its 64-row blocks and at least two key
    tiles, a head width it was built for."""
    if K.stream_supported(t, t, d):
        assert t % K.STREAM_SM90_BLOCK == 0 and t >= 2 * K.STREAM_SM90_BLOCK
        assert d in K.STREAM_SM90_WIDTHS
        assert K._stream_dims(torch.empty(2, t, d, device="meta")) == (2, t, d)


def _stream_sm90_attention(q, k, v, fault):
    """``ur_attention_stream_sm90``'s arithmetic in plain torch, with one of its
    faults planted.

    64-key tiles; the output columns in groups of ``64 * NO`` (NO = 2 at
    d = 512), each owned by one consumer (even groups the first, odd the
    second), and each consumer's S the sum of the two fp32 partial products
    over the halves of d; fp32 running max and row sum; probabilities
    rounded to bf16 before the PV product. Faults: the last tile's last 64
    columns of K stale (from an earlier tile), O or the row sum not rescaled,
    the second consumer's S without the first's partial, or its V chunks
    offset by one (its first chunk the first consumer's last).
    """
    qf, kf, vf = q.float(), k.float(), v.float()
    t, d = k.shape[1], k.shape[2]
    h, width = d // 2, 64 * (2 if (d // 64) % 4 == 0 else 1)
    groups = []
    for col in range(0, d, width):
        second = (col // width) % 2 == 1
        offset = 64 if fault == "v_chunks_offset" and second else 0
        vg = vf[..., col - offset:col + width - offset]
        m = torch.full(q.shape[:-1] + (1,), -torch.inf)
        l = torch.zeros_like(m)
        acc = torch.zeros(q.shape[:-1] + (width,))
        for k0 in range(0, t, 64):
            kt = kf[:, k0:k0 + 64].clone()
            if fault == "last_k_chunk_stale" and k0 == t - 64:
                kt[..., -64:] = kf[:, k0 - 64:k0, -64:]
            partial = [qf[..., i * h:(i + 1) * h] @ kt[..., i * h:(i + 1) * h].transpose(1, 2)
                       for i in range(2)]
            s = partial[1] if fault == "partner_partial_not_added" and second else sum(partial)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = (l if fault == "row_sum_not_rescaled" else l * corr) + p.sum(-1, keepdim=True)
            acc = acc if fault == "accumulator_not_rescaled" else acc * corr
            acc = acc + p.to(torch.bfloat16).float() @ vg[:, k0:k0 + 64]
            m = m_new
        groups.append(acc / l)
    return torch.cat(groups, -1).to(torch.bfloat16)


@pytest.mark.parametrize("fault", ["none", "last_k_chunk_stale", "accumulator_not_rescaled",
                                   "row_sum_not_rescaled", "partner_partial_not_added",
                                   "v_chunks_offset"])
@pytest.mark.parametrize("shape", [(1, 1024, 512), (1, 4096, 512)])
def test_bf16_tolerance_passes_the_stream_sm90_arithmetic_and_rejects_faults(shape, fault):
    """The same limit at ``ur_attention_stream_sm90``'s arithmetic (split d,
    columns in 128-wide groups, 64-key tiles) at d = 512: it passes, and
    each of the kernel's planted faults fails."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(31, shape, shape[-1]))
    ratio = K.bf16_tolerance_ratio(_stream_sm90_attention(q, k, v, fault),
                                   K.attention_bh_plain(q, k, v))
    assert (ratio <= 1.0) == (fault == "none"), ratio


def test_bh_routes_bf16_to_the_sm90_kernel():
    """bf16 head-major launches take ``ur_attention_bh_sm90`` in its own
    source, fp32 ones the FMA kernel ``ur_attention_bh``; ``build_all`` builds
    the new source with the others."""
    kern = K.fused_attention_bh_prescaled
    assert kern.entry(torch.bfloat16) == ("ur_attention_bh_sm90", K.library_bh_sm90,
                                          K.SOURCE_BH_SM90)
    assert kern.entry(torch.float32) == ("ur_attention_bh", K.library, K.SOURCE)
    assert K.SOURCE_BH_SM90.is_file() and K.SOURCE_BH_SM90.parent == K.SOURCE.parent
    assert K.SOURCE_BH_SM90 in KN.SOURCES and len(set(KN.SOURCES)) == len(KN.SOURCES) == 7


@pytest.mark.parametrize("d", [32, 64, 96, 128, 192])
@pytest.mark.parametrize("t", _T)
def test_supported_shapes_meet_the_bh_sm90_kernel_preconditions(t, d):
    """Every shape the head-major route admits meets what ``ur_attention_bh_sm90``
    checks (T >= BH_SM90_MIN_T, a head width it was built for); T need not be
    a multiple of its 64-row blocks, whose last one it masks."""
    if K.supported(t, t, d):
        assert t >= K.BH_SM90_MIN_T and d in K.BH_SM90_WIDTHS
        assert K._bh_dims(torch.empty(3, t, d, device="meta")) == (3, t, d)
    else:
        with pytest.raises(ValueError, match="unsupported"):
            K._bh_dims(torch.empty(3, t, d, device="meta"))


def _bh_sm90_attention(q, k, v, fault):
    """``ur_attention_bh_sm90``'s arithmetic in plain torch, with one of its
    faults planted.

    64-key tiles, the last one zero-filled past T (as TMA fills it) and its
    keys at or past T masked before the row max; fp32 running max and row
    sum; probabilities rounded to bf16 before the PV product. Faults: the
    tail keys not masked (zero rows counted at logit 0), the last tile stale
    (its K and V those of the tile before it, as when its load is skipped),
    O not rescaled.
    """
    n, t, d = k.shape
    tiles = -(-t // K.BH_SM90_BLOCK)
    pad = tiles * K.BH_SM90_BLOCK - t
    kf = torch.cat([k.float(), k.new_zeros(n, pad, d).float()], 1)
    vf = torch.cat([v.float(), v.new_zeros(n, pad, d).float()], 1)
    m = torch.full(q.shape[:-1] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape[:-1] + (d,))
    for j in range(tiles):
        k0 = (j - 1 if fault == "last_tile_stale" and j == tiles - 1 else j) * K.BH_SM90_BLOCK
        s = q.float() @ kf[:, k0:k0 + K.BH_SM90_BLOCK].transpose(1, 2)
        keys = torch.arange(j * K.BH_SM90_BLOCK, (j + 1) * K.BH_SM90_BLOCK)
        if fault != "tail_keys_not_masked":
            s = s.masked_fill(keys >= t, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc if fault == "accumulator_not_rescaled" else acc * corr
        acc = acc + p.to(torch.bfloat16).float() @ vf[:, k0:k0 + K.BH_SM90_BLOCK]
        m = m_new
    return (acc / l).to(torch.bfloat16)


@pytest.mark.parametrize("fault", ["none", "tail_keys_not_masked", "last_tile_stale",
                                   "accumulator_not_rescaled"])
@pytest.mark.parametrize("shape", [(3, 264, 64), (2, 328, 128), (4, 256, 64)])
def test_bf16_tolerance_passes_the_bh_sm90_arithmetic_and_rejects_faults(shape, fault):
    """The same limit at ``ur_attention_bh_sm90``'s arithmetic (64-key tiles,
    a zero-filled and masked last tile where T % 64 != 0): it passes, and each
    of the kernel's planted faults fails. At T = 256 no key lies past T, so
    the unmasked tail computes exactly what the sound kernel does there."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(32, shape, shape[-1]))
    out = _bh_sm90_attention(q, k, v, fault)
    ratio = K.bf16_tolerance_ratio(out, K.attention_bh_plain(q, k, v))
    if fault == "tail_keys_not_masked" and shape[1] % K.BH_SM90_BLOCK == 0:
        assert torch.equal(out, _bh_sm90_attention(q, k, v, "none"))
    else:
        assert (ratio <= 1.0) == (fault == "none"), ratio


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


# ---------------------------------------------------------------------------
# the out-projection-fused kernel (``_btc_out_kernel``)
# ---------------------------------------------------------------------------


def _qkvw(seed, shape, c_out):
    q, k, v = _qkv(seed, shape, 64)
    wo = nhwc(seed + 3, shape[-1], c_out, scale=shape[-1] ** -0.5)
    return q, k, v, wo


@pytest.mark.parametrize("c_out", [96, 128])
def test_btc_out_plain_matches_pallas_interpret(c_out):
    q, k, v, wo = _qkvw(70, (2, 256, 128), c_out)
    ref = PA._fused_raw_btc_out(*map(jnp.asarray, (q, k, v, wo)), 64, interpret=True)
    args = [torch.from_numpy(a) for a in (q, k, v, wo)]
    out = K.attention_btc_out_plain(*args)
    assert out.shape == (2, 256, c_out)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), **TOL)
    kern = K.fused_attention_btc_out_prescaled
    before = kern.launches
    np.testing.assert_array_equal(to_np(kern(*args)), to_np(out))
    assert kern.launches == before == 0


@pytest.mark.parametrize("c_out,chunk", [(96, None), (128, None), (128, 64)])
def test_btc_out_gradients_match_jax(c_out, chunk):
    """dq, dk, dv and dwo of the autograd function (``chunk=None``; T = 256 is
    one chunk) and of the 64-query chunked backward == ``jax.grad`` through the
    JAX custom VJP, within 1e-4 of each gradient's largest entry."""
    q, k, v, wo = _qkvw(80, (2, 256, 128), c_out)
    g = nhwc(84, 2, 256, c_out)
    fused = PA._make_diffable_btc_out(functools.partial(PA._fused_raw_btc_out, interpret=True))
    want = jax.grad(lambda *xs: jnp.sum(fused(*xs, 64) * g), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (q, k, v, wo)))
    kern = K.fused_attention_btc_out_prescaled
    if chunk is None:
        xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, wo)]
        before = kern.backwards
        got = torch.autograd.grad(kern(*xs), xs, torch.from_numpy(g))
        assert kern.backwards == before + 1
    else:
        got = K.attention_btc_out_vjp(*map(torch.from_numpy, (q, k, v, wo, g)), chunk=chunk)
    for name, a, b in zip(("dq", "dk", "dv", "dwo"), got, want):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(to_np(a), b, atol=1e-4 * np.abs(b).max(), rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("c_out", [64, 96, 128, 256, 320, 448, 640, 1280])
def test_fused_out_route_matches_jax(monkeypatch, c_out):
    assert not TA._use_btc_fused_out(c_out) and not JA._use_btc_fused_out(c_out)
    monkeypatch.setenv("UNIRESTORE_FUSED_OUT_ATTN", "1")
    with TA.fused_out_projection(True):
        assert TA._use_btc_fused_out(c_out) == JA._use_btc_fused_out(c_out)
        with TA.fused_out_projection(False):
            assert not TA._use_btc_fused_out(c_out)
    assert not TA._use_btc_fused_out(c_out)


class _Spy:
    """Counts the calls to a kernel wrapper and records the widths it was given."""

    def __init__(self, kern):
        self.kern, self.calls = kern, []

    def __call__(self, q, k, v, wo):
        self.calls.append((tuple(q.shape), tuple(wo.shape)))
        return self.kern(q, k, v, wo)


def test_mha_fused_out_matches_jax(monkeypatch):
    """T = 1024, C = 128 in two 64-wide heads: the fused route (bias added after
    the kernel) == JAX's plain route on the CPU, 1e-5."""
    spy = _Spy(K.fused_attention_btc_out_prescaled)
    monkeypatch.setattr(K, "fused_attention_btc_out_prescaled", spy)
    pj = jax_params(JA.mha_init, 128, 2, 64, None, True)
    pt = port_params(pj, TA.mha_init, 128, 2, 64, None, True)
    x = nhwc(90, 2, 1024, 128)
    ref = JA.mha(pj, jnp.asarray(x), heads=2)
    with TA.fused_out_projection(True):
        out = TA.mha(pt, torch.from_numpy(x), heads=2)
    assert spy.calls == [((2, 1024, 128), (128, 128))]
    np.testing.assert_allclose(to_np(out), np.asarray(ref), **TOL)


def test_restore_with_fused_out_attention_matches_jax(monkeypatch):
    """A narrow config whose UNet level 0 holds 128 channels in two 64-wide
    heads, at 256 px (T = 1024 there), 2 steps: ``fused_out_attention=True``
    routes those self-attentions through the fused wrapper and the restore
    equals JAX ``restore_padded`` (plain route on the CPU) within 2e-4."""
    from test_torch_bridge import tiny_pair
    from test_torch_pipeline import TOL as RESTORE_TOL
    from test_torch_pipeline import _jax_noise
    from unirestore_torch.models import unirestore as TUR
    from unirestore_tpu.models import unirestore as JUR

    def narrow(cfg):
        return dataclasses.replace(cfg, unet=dataclasses.replace(
            cfg.unet, block_out_channels=(128, 64, 64, 64)))

    cj = narrow(JUR.tiny_config())
    ct = dataclasses.replace(narrow(TUR.tiny_config()), fused_out_attention=True)
    (fj, tj), (ft, tt) = tiny_pair(cj, ct, seed=31)
    images = np.random.default_rng(32).uniform(size=(1, 256, 256, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(33)
    post, diff = _jax_noise(cj, images.shape, rng)
    ref = jax.jit(lambda f, t, x, r: JUR.restore_padded(f, t, cj, JUR.schedule(cj), x, "ir",
                                                        r, 2))(fj, tj, images, rng)
    spy = _Spy(K.fused_attention_btc_out_prescaled)
    monkeypatch.setattr(K, "fused_attention_btc_out_prescaled", spy)
    out = TUR.restore_padded(ft, tt, ct, TUR.schedule(ct), torch.from_numpy(images), "ir",
                             num_inference_steps=2, posterior_noise=post, diffusion_noise=diff,
                             device="cpu")
    # two steps x (2 down + 3 up) level-0 transformer blocks, each (B, 1024, 128) @ (128, 128)
    assert spy.calls == [((1, 1024, 128), (128, 128))] * 10
    assert not TA._FUSED_OUT
    np.testing.assert_allclose(to_np(out), np.asarray(ref), **RESTORE_TOL)


def test_btc_out_dims_take_every_routed_shape():
    for t, inner, c_out in [(4096, 320, 320), (1024, 640, 640), (4096, 256, 256),
                            (1024, 256, 256), (1024, 1280, 1280), (1536, 640, 640)]:
        q, wo = torch.empty(8, t, inner, device="meta"), torch.empty(inner, c_out, device="meta")
        assert K._btc_out_dims(q, wo) == (8, t, inner, c_out)
    for q_shape, wo_shape in [((2, 1024, 128), (128, 96)),     # C not routed
                              ((2, 1024, 128), (128, 0)),      # no output column
                              ((2, 1024, 0), (0, 128)),        # no head
                              ((2, 1000, 128), (128, 128)),    # T not routed
                              ((2, 1024, 128), (256, 128)),    # wo rows != inner
                              ((2, 1024, 2048), (2048, 256))]:  # O tile past shared memory
        with pytest.raises(ValueError, match="unsupported"):
            K._btc_out_dims(torch.empty(q_shape), torch.empty(wo_shape))


def _online_attention_out(q, k, v, wo, fault):
    """The bf16 fused kernel's arithmetic in plain torch, with one of its faults
    planted: per head ``_online_attention`` rounded to bf16 into the O tile,
    then the fp32 product over 64-row chunks of wo, rounded once."""
    b, t, inner = q.shape
    heads = inner // 64
    o = _online_attention(*(x.reshape(b, t, heads, 64).transpose(1, 2).reshape(b * heads, t, 64)
                            for x in (q, k, v)), "none")
    o = o.reshape(b, heads, t, 64).transpose(1, 2).reshape(b, t, inner).float()
    if fault == "head_left_out":  # the first head's slot of the O tile
        o[..., :64] = 0.0
    rows = inner - (64 if fault == "last_k_chunk_dropped" else 0)
    return (o[..., :rows] @ wo[:rows].float()).to(torch.bfloat16)


@pytest.mark.parametrize("fault", ["none", "head_left_out", "last_k_chunk_dropped"])
@pytest.mark.parametrize("shape,c_out", [((1, 1024, 320), 320), ((1, 1024, 1280), 1280)])
def test_btc_out_tolerance_passes_kernel_arithmetic_and_rejects_faults(shape, c_out, fault):
    """chip_smoke.py holds the fused kernel to ``bf16_out_tolerance_ratio <= 1``:
    the kernel's arithmetic passes it, the two planted faults read above 5."""
    q, k, v, wo = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkvw(100, shape, c_out))
    ref = K.attention_btc_out_plain(q, k, v, wo)
    ratio = K.bf16_out_tolerance_ratio(_online_attention_out(q, k, v, wo, fault), ref)
    assert ratio <= 1.0 if fault == "none" else ratio > 5.0, ratio


# ---------------------------------------------------------------------------
# the Hopper out-projection-fused kernel (ur_attention_btc_out_sm90)
# ---------------------------------------------------------------------------


def test_btc_out_routes_bf16_to_the_sm90_kernel():
    """bf16 out-projection-fused launches take ``ur_attention_btc_out_sm90`` in
    its own source, fp32 ones the FMA kernel ``ur_attention_btc_out``;
    ``build_all`` builds the new source with the others."""
    kern = K.fused_attention_btc_out_prescaled
    assert kern.entry(torch.bfloat16) == ("ur_attention_btc_out_sm90", K.library_out_sm90,
                                          K.SOURCE_OUT_SM90)
    assert kern.entry(torch.float32) == ("ur_attention_btc_out", K.library, K.SOURCE)
    assert K.SOURCE_OUT_SM90.is_file() and K.SOURCE_OUT_SM90.parent == K.SOURCE.parent
    assert K.SOURCE_OUT_SM90 in KN.SOURCES


@settings(max_examples=300, deadline=None, database=None)
@given(t=st.one_of(st.integers(0, 1 << 15), st.integers(0, 64).map(lambda n: 256 * n)),
       inner=st.integers(0, 26).map(lambda n: 64 * n),
       c_out=st.one_of(st.integers(0, 4096), st.integers(0, 32).map(lambda n: 128 * n),
                       st.sampled_from([320, 640])),
       batch=st.sampled_from([1, 2, 4, 8, 64]), sms=st.sampled_from([132, 114, 78]))
def test_btc_out_shapes_meet_the_sm90_kernel_preconditions(t, inner, c_out, batch, sms):
    """Every shape the fused route admits (``_btc_out_dims``) meets what
    ``ur_attention_btc_out_sm90`` checks (T a multiple of its 128-row blocks,
    whole 64-wide heads, whole 64-column output chunks), its tensor maps'
    limits (16-byte strides under 2^40, dims under 2^32), and its cluster rule
    on any card: 1 <= G <= min(8, H), the head slots within the card's shared
    memory, epilogue passes of 1-4 chunks that cover each CTA's share."""
    q = torch.empty(batch, t, inner, device="meta")
    wo = torch.empty(inner, c_out, device="meta")
    try:
        dims = K._btc_out_dims(q, wo)
    except ValueError:
        return
    assert dims == (batch, t, inner, c_out)
    assert t % K.BTC_OUT_SM90_BLOCK == 0 and t >= K.BTC_OUT_SM90_BLOCK
    assert inner % 64 == 0 and 0 < inner <= K.BTC_OUT_MAX_INNER and c_out % 64 == 0
    for width in (inner, c_out):
        assert (2 * width) % 16 == 0 and 2 * width * t * batch < 2 ** 40
    assert max(inner, c_out, t, batch) < 2 ** 32
    heads = inner // 64
    g = K.btc_out_sm90_cluster(heads, batch * t // K.BTC_OUT_SM90_BLOCK, sms)
    assert 1 <= g <= min(K.BTC_OUT_SM90_MAX_CLUSTER, heads)
    assert K.btc_out_sm90_smem_bytes(heads, g) <= K.BTC_OUT_SM90_MAX_SMEM
    nq = K.btc_out_sm90_chunk_group(c_out, g)
    most = -(-(c_out // 64) // g)
    assert 1 <= nq <= K.BTC_OUT_SM90_MAX_CHUNKS and nq <= most
    assert -(-most // nq) == -(-most // K.BTC_OUT_SM90_MAX_CHUNKS)  # the fewest passes


def test_btc_out_sm90_cluster_rule_at_the_main_paths_shapes():
    """At the restore's and the server's shapes on an H100 (132 SMs) the rule
    takes G = 1 where B * T / 128 blocks fill the card, and more CTAs where
    they do not."""
    want = {(8, 4096, 320): 1, (8, 1024, 640): 2, (8, 4096, 256): 1, (8, 1024, 256): 2,
            (4, 4096, 320): 1, (4, 1024, 640): 3, (4, 4096, 256): 1, (4, 1024, 256): 3,
            (1, 6144, 320): 2, (1, 1536, 640): 6, (1, 6144, 256): 2, (1, 1536, 256): 4}
    got = {(b, t, i): K.btc_out_sm90_cluster(i // 64, b * t // 128, 132) for b, t, i in want}
    assert got == want


@functools.cache
def _btc_out_case(shape):
    """Seeded bf16 q, k, v, wo (C = inner) and the per-head bf16 outputs of the
    Hopper kernel's attention body (128-key tiles), (B, T, inner)."""
    q, k, v, wo = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkvw(110, shape, shape[-1]))
    b, t, inner = shape
    split = [x.reshape(b, t, inner // 64, 64).transpose(1, 2).reshape(-1, t, 64) for x in (q, k, v)]
    o = _online_attention(*split, "none", block_k=K.BTC_SM90_BLOCK)
    o = o.reshape(b, inner // 64, t, 64).transpose(1, 2).reshape(b, t, inner)
    return q, k, v, wo, o


def _btc_out_sm90_model(q, k, v, wo, groups, fault):
    """``ur_attention_btc_out_sm90``'s arithmetic in plain torch, with one of its
    faults planted.

    Each head by ``_online_attention`` over 128-key tiles, rounded to bf16 (CTA
    r of the cluster of ``groups`` attends to heads r, r + G, ... into slots
    0, 1, ...); CTA r's share of the C / 64 output chunks, columns
    [64 C r / (64 G), ...), summed over every head in the kernel's k order
    (head by head, 16 rows of wo at a time) in fp32 and rounded once. Faults:
    a peer's head slot read from the CTA's own rank (the slot of the same
    index there, zeros past its last head), CTA 0's column share taken from
    the wo columns one chunk to the right, the last head's 64 rows of wo
    dropped, a head (the first) left out.
    """
    b, t, inner = q.shape
    c_out, heads = wo.shape[1], inner // 64
    o = _btc_out_case(tuple(q.shape))[4].float()
    wf = wo.float()
    n_chunks = c_out // 64
    out = torch.empty(b, t, c_out)
    for rank in range(groups):
        lo, hi = n_chunks * rank // groups, n_chunks * (rank + 1) // groups
        for c in range(lo, hi):
            src = min(c + 1, n_chunks - 1) if fault == "column_share_offset" and rank == 0 else c
            acc = torch.zeros(b, t, 64)
            for h in range(heads):
                if (fault == "head_left_out" and h == 0
                        or fault == "last_wo_chunk_dropped" and h == heads - 1):
                    continue
                slot = h
                if fault == "peer_slice_from_own_rank" and h % groups != rank:
                    slot = rank + (h // groups) * groups  # the same slot index, own rank
                for kk in range(4):
                    rows = slice(64 * h + 16 * kk, 64 * h + 16 * kk + 16)
                    a = (o[..., 64 * slot + 16 * kk:64 * slot + 16 * kk + 16] if slot < heads
                         else torch.zeros(b, t, 16))
                    acc += a @ wf[rows, 64 * src:64 * src + 64]
            out[..., 64 * c:64 * c + 64] = acc
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("fault", ["none", "peer_slice_from_own_rank", "column_share_offset",
                                   "last_wo_chunk_dropped", "head_left_out"])
@pytest.mark.parametrize("groups", [1, 2, 5])
@pytest.mark.parametrize("shape", [(1, 1024, 320), (1, 1024, 640), (1, 1024, 1280)])
def test_btc_out_tolerance_passes_the_sm90_arithmetic_and_rejects_faults(shape, groups, fault):
    """chip_smoke.py holds the Hopper fused kernel to ``bf16_out_tolerance_ratio
    <= 1`` at every cluster size: its arithmetic passes at G = 1, 2, 5, and each
    of its planted faults reads above 5. A single CTA reads no peer, so at
    G = 1 the peer fault computes exactly the sound arithmetic."""
    q, k, v, wo, _ = _btc_out_case(shape)
    ref = K.attention_btc_out_plain(q, k, v, wo)
    out = _btc_out_sm90_model(q, k, v, wo, groups, fault)
    ratio = K.bf16_out_tolerance_ratio(out, ref)
    if fault == "peer_slice_from_own_rank" and groups == 1:
        assert torch.equal(out, _btc_out_sm90_model(q, k, v, wo, 1, "none"))
    else:
        assert ratio <= 1.0 if fault == "none" else ratio > 5.0, ratio
