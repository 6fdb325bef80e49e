"""Port parity: the restore under ``control_type="spade"`` in the three cache
modes (``models/unirestore.py:restore_core`` against the JAX
``restore_padded``'s encode -> noise to t=999 -> ``ddim_denoise`` -> decode).

The tiny config's seeded init with every all-zero leaf filled (Controller zero
convs, NAF gates, TFA prompts and the null embedding given weights,
``tests/test_torch_eval.py:filled_init``), one 128 px image. The JAX side runs
``restore_padded``'s four steps with its own draws: the encode and the decode
jitted once for all three modes, ``ddim_denoise`` once per mode (an XLA
compile of the whole restore per mode takes 30-55 s on this CPU). Three DDIM
steps at stride 2 and warmup 1: one exact warmup step, then one key step and
its follower, which runs the decoder alone (``encoder``) or the level-0
``unet_down_shallow`` / ``unet_up_shallow`` pair (``deep``). Tolerance 2e-4
(``tests/test_torch_pipeline.py``'s reasoning: the UNet and Controller three
times between an encode and a decode, the t=999 update amplifying the
summation-order differences of XLA:CPU and oneDNN).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bridge import to_np
from test_torch_eval import filled_init
from unirestore_torch import bridge
from unirestore_torch.models import unirestore as TUR
from unirestore_tpu.models import unirestore as JUR

torch.set_num_threads(2)
TOL = dict(atol=2e-4, rtol=2e-4)
STEPS = 3


@functools.lru_cache(maxsize=None)
def _setup():
    """The port's seeded tiny SPADE model with its all-zero leaves filled,
    carried to the JAX layout (the eager JAX init takes seconds); a 128 px
    image (at 64 px the UNet's 1 x 1 level leaves two values to each SPADE
    GroupNorm group, and fp32 there is 1.6e-4 from fp64 in either framework);
    the JAX encode and the noising, and the JAX decode jitted once."""
    cj = JUR.tiny_config(control_type="spade")
    ct = TUR.tiny_config(control_type="spade")
    ft, tt = filled_init(ct, seed=21)
    fj, tj = (jax.tree.map(jnp.asarray, bridge.to_numpy_tree(t)) for t in (ft, tt))
    images = np.random.default_rng(22).uniform(size=(1, 128, 128, 3)).astype(np.float32)
    k_enc, k_diff = jax.random.split(jax.random.PRNGKey(23))
    z0, skips = jax.jit(lambda f, t, x, k: JUR.encode(f, t, cj, x, rng=k, enable_fr=True))(
        fj, tj, images, k_enc)
    sched = JUR.schedule(cj)
    zt, noise, _ = JUR.diffuse(sched, z0, k_diff, timesteps=np.full((1,), 999, np.int32))
    post = np.array(jax.random.normal(k_enc, z0.shape))
    decode = jax.jit(lambda f, t, z, s: JUR.decode(f, t, cj, z, s, "seg"))
    return cj, ct, (fj, tj), (ft, tt), images, (z0, skips, zt), (post, np.array(noise)), decode


@pytest.mark.parametrize("mode", ["none", "encoder", "deep"])
def test_spade_restore_core_cache_modes_match_jax(mode):
    cj, ct, (fj, tj), (ft, tt), images, (z0, skips, zt), (post, noise), decode = _setup()
    assert "spades" in tt["control"] and "unet" in ft
    kw = dict(cache_mode=mode, cache_stride=2, cache_warmup=1)
    cj, ct = dataclasses.replace(cj, **kw), dataclasses.replace(ct, **kw)
    sched = JUR.schedule(cj)
    z = jax.jit(lambda f, t, zt, z0: JUR.ddim_denoise(f, t, cj, sched, zt, z0, STEPS))(
        fj, tj, zt, z0)
    ref = decode(fj, tj, z, skips)

    out = TUR.restore_core(ft, tt, ct, TUR.schedule(ct), torch.from_numpy(images), "seg",
                           torch.from_numpy(post), torch.from_numpy(noise),
                           num_inference_steps=STEPS)
    assert out.shape == images.shape
    np.testing.assert_allclose(to_np(out), np.asarray(ref), **TOL)
