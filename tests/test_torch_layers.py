"""Port parity: layers, embeddings, schedules and resize against the JAX package.

Same seeded numpy inputs and re-randomised params through both sides, on the
CPU in fp32. Tolerances:

- conv / matmul layers: atol = rtol = 1e-5 relative to O(1) outputs. XLA:CPU
  and oneDNN sum the products in different orders; fp32 rounding of a
  few-hundred-term dot product stays near 1e-6.
- norms: 1e-5. Both sides compute E[x^2] - E[x]^2 in fp32 and fold the
  affine the same way, so only summation order differs.
- schedules: 1e-6; identical fp32 formulas on the same fp32 table.
- bicubic resize: 1e-5; both gather and sum 4 taps per axis in fp32 with
  float64 tap positions and weights (the port's ``ops/resize.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bridge import jax_params, nhwc, port_params, to_np
from unirestore_torch.diffusion import schedules as TD
from unirestore_torch.models import unirestore as TUR
from unirestore_torch.nn import embeddings as TE
from unirestore_torch.nn import layers as TL
from unirestore_torch.nn import resnet as TR
from unirestore_torch.ops import resize as TRS
from unirestore_tpu.diffusion import schedules as JD
from unirestore_tpu.models import unirestore as JUR
from unirestore_tpu.nn import embeddings as JE
from unirestore_tpu.nn import layers as JL
from unirestore_tpu.nn import resnet as JR
from unirestore_tpu.ops import resize as JRS

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)


def close(port, ref, **tol):
    np.testing.assert_allclose(to_np(port), np.asarray(ref), **(tol or TOL))


@pytest.mark.parametrize("cin,cout,k,groups,stride,padding", [
    (8, 16, 3, 1, 1, 1),
    (32, 32, 3, 16, 1, 1),           # CFRM grouped 3x3
    (16, 16, 3, 16, 1, 1),           # depthwise (NAF conv2)
    (8, 12, 1, 1, 1, 0),             # pointwise
    (8, 8, 3, 1, 2, 1),              # UNet downsample
    (8, 8, 3, 1, 1, ((0, 1), (2, 1))),  # explicit asymmetric padding
    (8, 8, 3, 1, 2, "VALID"),
    (8, 8, 3, 1, 1, "SAME"),
])
def test_conv2d(cin, cout, k, groups, stride, padding):
    pj = jax_params(JL.conv2d_init, cin, cout, k, groups)
    pt = port_params(pj, TL.conv2d_init, cin, cout, k, groups)
    x = nhwc(0, 2, 9, 11, cin)
    ref = JL.conv2d(pj, jnp.asarray(x), stride=stride, padding=padding, groups=groups)
    out = TL.conv2d(pt, torch.from_numpy(x), stride=stride, padding=padding, groups=groups)
    close(out, ref)


@pytest.mark.parametrize("fn", ["downsample_asym", "downsample_sym", "upsample"])
def test_resamplers(fn):
    pj = jax_params(JR.downsample_init, 8)
    pt = port_params(pj, TR.downsample_init, 8)
    x = nhwc(1, 2, 8, 10, 8)
    if fn == "upsample":
        ref, out = JR.upsample(pj, jnp.asarray(x)), TR.upsample(pt, torch.from_numpy(x))
    else:
        mode = fn.split("_")[1]
        ref = JR.downsample(pj, jnp.asarray(x), pad_mode=mode)
        out = TR.downsample(pt, torch.from_numpy(x), pad_mode=mode)
    close(out, ref)


def test_linear():
    pj = jax_params(JL.linear_init, 24, 40)
    pt = port_params(pj, TL.linear_init, 24, 40)
    x = nhwc(2, 3, 7, 24)
    close(TL.linear(pt, torch.from_numpy(x)), JL.linear(pj, jnp.asarray(x)))


@pytest.mark.parametrize("norm", ["group", "layer", "instance"])
def test_norms(norm):
    pj = jax_params(lambda key, c: JL.norm_init(c), 32)
    pt = port_params(pj, TL.norm_init, 32)
    # offset mean: E[x^2] - E[x]^2 cancels more when |mean| >> std
    x = nhwc(3, 2, 6, 5, 32, scale=3.0) + 1.5
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if norm == "group":
        ref, out = JL.group_norm(pj, xj, groups=8, eps=1e-6), TL.group_norm(pt, xt, 8, 1e-6)
    elif norm == "layer":
        ref, out = JL.layer_norm(pj, xj), TL.layer_norm(pt, xt)
    else:
        ref, out = JL.instance_norm(xj), TL.instance_norm(xt)
    close(out, ref)


@pytest.mark.parametrize("name", ["silu", "gelu", "simple_gate", "upsample_nearest_2x",
                                  "pixel_shuffle", "global_avg_pool"])
def test_activations_and_resampling(name):
    x = nhwc(4, 2, 5, 6, 8, scale=2.0)
    close(getattr(TL, name)(torch.from_numpy(x)), getattr(JL, name)(jnp.asarray(x)))


def test_timestep_embedding_and_mlp():
    t = np.array([0, 1, 249, 999], np.int32)
    for dim in (32, 33):
        close(TE.sinusoidal_timestep_embedding(torch.from_numpy(t), dim),
              JE.sinusoidal_timestep_embedding(jnp.asarray(t), dim), atol=2e-5, rtol=1e-5)
    pj = jax_params(JE.timestep_mlp_init, 32, 64)
    pt = port_params(pj, TE.timestep_mlp_init, 32, 64)
    emb = nhwc(5, 4, 32)
    close(TE.timestep_mlp(pt, torch.from_numpy(emb)), JE.timestep_mlp(pj, jnp.asarray(emb)))


@pytest.mark.parametrize("n", [1, 4, 20])
def test_ddim_timesteps(n):
    np.testing.assert_array_equal(TD.ddim_timesteps(n), JD.ddim_timesteps(n))


def test_schedule_math():
    sj, st = JD.make_schedule(), TD.make_schedule()
    close(st.alphas_cumprod, sj.alphas_cumprod, atol=0, rtol=0)
    z, eps = nhwc(6, 2, 4, 4, 4), nhwc(7, 2, 4, 4, 4)
    zj, ej, zt, et = jnp.asarray(z), jnp.asarray(eps), torch.from_numpy(z), torch.from_numpy(eps)
    tsteps = np.array([999, 3], np.int32)
    close(TD.add_noise(st, zt, et, torch.from_numpy(tsteps)),
          JD.add_noise(sj, zj, ej, jnp.asarray(tsteps)), atol=1e-6, rtol=1e-6)
    close(TD.predict_x0_from_eps(st, zt, et, torch.from_numpy(tsteps)),
          JD.predict_x0_from_eps(sj, zj, ej, jnp.asarray(tsteps)), atol=1e-5, rtol=1e-6)
    # t=999 .. 49 with n=20 crosses prev_t < 0 at the last step (final_alpha_cumprod)
    for t, n in ((999, 20), (49, 20), (249, 4), (0, 1), (999, 1)):
        close(TD.ddim_step(st, zt, et, t, n), JD.ddim_step(sj, zj, ej, t, n),
              atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("size", [(13, 17), (40, 24), (9, 9)])
def test_resize_bicubic(size):
    x = nhwc(8, 2, 11, 14, 3)
    close(TRS.resize_bicubic(torch.from_numpy(x), size), JRS.resize_bicubic(jnp.asarray(x), size))


def test_reflect_pad():
    x = nhwc(9, 1, 7, 9, 3)
    for ph, pw in ((0, 0), (3, 0), (2, 5)):
        close(TRS.reflect_pad_hw(torch.from_numpy(x), ph, pw),
              JRS.reflect_pad_hw(jnp.asarray(x), ph, pw), atol=0, rtol=0)


@pytest.mark.parametrize("h,w,expect", [
    (4, 5, (10, 12)),    # 12.5 rounds to even
    (4, 7, (10, 18)),    # 17.5 rounds to even
    (4, 9, (10, 22)),    # 22.5 rounds to even
    (50, 70, (50, 70)),  # no resize, pad only
])
def test_preprocess_shape_bankers_rounding(h, w, expect):
    kw = dict(min_size=10, pad_multiple=8)
    cj = dataclasses.replace(JUR.tiny_config(), **kw)
    ct = dataclasses.replace(TUR.tiny_config(), **kw)
    got = TUR.preprocess_shape(h, w, ct)
    assert got == JUR.preprocess_shape(h, w, cj)
    assert got[:2] == expect
