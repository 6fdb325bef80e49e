"""Port parity: the whole restore path on ``tiny_config()``.

The JAX side draws its posterior and diffusion noise from its key; the test
recomputes those draws (``k_enc, k_diff = split(rng)``; ``normal(k_enc,
mean.shape)``; ``k_t, k_n = split(k_diff)``; ``normal(k_n, latents.shape)``)
and hands them to the port. Every param leaf is re-randomised so the CFRM,
Controller, SC-Tuner and TFA paths move the output. fp32 on the CPU.

Tolerance 2e-4: five DDIM steps chain the Controller and UNet five times
between a VAE encode and decode, and XLA:CPU and oneDNN sum their convs and
matmuls in different orders (1e-6-level per op). The DDIM update at t=999
divides by sqrt(alpha_bar) ~ 0.07, which amplifies those differences.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_bridge import tiny_pair, to_np
from unirestore_torch.models import unirestore as TUR
from unirestore_tpu.models import unirestore as JUR

torch.set_num_threads(2)
TOL = dict(atol=2e-4, rtol=2e-4)


def _jax_noise(cfg, images_shape, rng):
    """The two normal draws ``restore_padded`` makes from ``rng``, as tensors."""
    b, h, w, _ = images_shape
    shape = (b, h // 8, w // 8, cfg.vae.latent_channels)  # the posterior mean's shape
    k_enc, k_diff = jax.random.split(rng)
    _, k_n = jax.random.split(k_diff)
    return (torch.tensor(np.asarray(jax.random.normal(k_enc, shape))),
            torch.tensor(np.asarray(jax.random.normal(k_n, shape))))


@pytest.mark.parametrize("mode", ["none", "encoder", "deep"])
def test_restore_padded_cache_modes(mode):
    # n=5, stride 3, warmup 1: one warmup step, one group of 3, one trailing full step
    kw = dict(cache_mode=mode, cache_stride=3, cache_warmup=1)
    cj = dataclasses.replace(JUR.tiny_config(), **kw)
    ct = dataclasses.replace(TUR.tiny_config(), **kw)
    (fj, tj), (ft, tt) = tiny_pair(cj, ct, seed=11)
    images = np.random.default_rng(12).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(13)
    post, diff = _jax_noise(cj, images.shape, rng)

    sched_j = JUR.schedule(cj)
    ref = jax.jit(lambda f, t, x, r: JUR.restore_padded(f, t, cj, sched_j, x, "seg", r, 5))(
        fj, tj, images, rng)
    out = TUR.restore_padded(ft, tt, ct, TUR.schedule(ct), torch.from_numpy(images), "seg",
                             num_inference_steps=5, posterior_noise=post,
                             diffusion_noise=diff, device="cpu")
    assert out.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), **TOL)
