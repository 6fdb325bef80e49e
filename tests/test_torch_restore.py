"""Port parity: ``restore`` (resize, reflect-pad, restore, crop, resize back).

Same setup and tolerance as test_torch_pipeline.py: noise recomputed from the
JAX key and injected, every param leaf re-randomised, fp32 on the CPU,
atol = rtol = 2e-4 for the chained DDIM steps between encode and decode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bridge import tiny_pair, to_np
from test_torch_pipeline import TOL, _jax_noise
from unirestore_torch.models import unirestore as TUR
from unirestore_tpu.models import unirestore as JUR
from unirestore_tpu.ops import resize as JRS

torch.set_num_threads(2)


def test_restore_resizes_and_pads():
    cj, ct = JUR.tiny_config(), TUR.tiny_config()
    (fj, tj), (ft, tt) = tiny_pair(cj, ct, seed=21)
    images = np.random.default_rng(22).uniform(size=(1, 50, 70, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(23)
    h, w, ph, pw = JUR.preprocess_shape(50, 70, cj)
    assert (h, w, ph, pw) == (64, 90, 0, 38)
    x = JRS.reflect_pad_hw(JRS.resize_bicubic(jnp.asarray(images), (h, w)), ph, pw)
    post, diff = _jax_noise(cj, x.shape, rng)

    sched_j = JUR.schedule(cj)
    ref = jax.jit(lambda f, t, x, r: JUR.restore(f, t, cj, sched_j, x, "cls", r, 2))(
        fj, tj, images, rng)
    out = TUR.restore(ft, tt, ct, TUR.schedule(ct), torch.from_numpy(images), "cls",
                      num_inference_steps=2, posterior_noise=post,
                      diffusion_noise=diff, device="cpu")
    assert out.shape == (1, 50, 70, 3)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), **TOL)


def test_restore_padded_draws_from_generator():
    """Without injected noise the draws come from the passed generator, reproducibly."""
    ct = TUR.tiny_config()
    ft, tt = TUR.init(ct, device="cpu")
    images = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    outs = [TUR.restore_padded(ft, tt, ct, TUR.schedule(ct), images, "ir",
                               torch.Generator().manual_seed(7), 2, device="cpu")
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1]) and torch.isfinite(outs[0]).all()
    with pytest.raises(ValueError, match="generator"):
        TUR.restore_padded(ft, tt, ct, TUR.schedule(ct), images, "ir", None, 2, device="cpu")
