"""The graph-captured restore's host side, on the CPU at ``tiny_config()``.

CUDA graphs run only on the card (``tests/test_torch_cuda.py`` holds a tiny
graph restore to the eager one there; ``chip_smoke.py`` phases 4, 5 and 8 the
full-width ones). Here:

- the noise drawn up front (``restore_noise``) is the noise ``VAE.encode`` and
  ``diffuse`` drew from the same seeded generator: equal outputs
  (``torch.equal``) in every cache mode and on the fused route;
- the device-only core that ``GraphedRestore`` captures matches the JAX
  ``restore`` at the tolerance of tests/test_torch_restore.py (2e-4);
- ``GraphedRestore`` and ``serve --cuda-graphs`` refuse the CPU, and the
  server's flag is off by default;
- the graph cache keeps at most ``max_graphs`` keys and evicts the least
  recently used (a stub capture stands in for the card).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bridge import tiny_pair, to_np
from test_torch_pipeline import TOL, _jax_noise
from unirestore_torch import graphs as GR
from unirestore_torch import serve
from unirestore_torch.models import unirestore as TUR
from unirestore_torch.nn import attention as TA
from unirestore_tpu.models import unirestore as JUR
from unirestore_tpu.ops import resize as JRS

torch.set_num_threads(2)

MODES = {"none": dict(cache_mode="none"),
         "encoder": dict(cache_mode="encoder", cache_stride=2),
         "deep": dict(cache_mode="deep", cache_stride=2),
         "fused": dict(cache_mode="none", fused_out_attention=True)}


def _drawn_in_place(ft, tt, cfg, sched, images, task, gen, steps):
    """The body ``restore_padded`` had while each draw sat where its noise is
    used: the posterior inside ``encode``, the diffusion noise inside ``diffuse``."""
    with torch.inference_mode(), TA.fused_out_projection(cfg.fused_out_attention):
        z0, skips = TUR.encode(ft, tt, cfg, images, generator=gen, enable_fr=True)
        t999 = torch.full((images.shape[0],), 999, dtype=torch.int32)
        zt, _, _ = TUR.diffuse(sched, z0, generator=gen, timesteps=t999)
        zt = TUR.ddim_denoise(ft, tt, cfg, sched, zt, z0, steps)
        return TUR.decode(ft, tt, cfg, zt, skips, task)


@pytest.mark.parametrize("mode", list(MODES))
def test_restore_noise_is_what_the_eager_restore_draws(mode):
    """Eager ``restore_padded`` with a seeded generator, the same with the noise
    drawn by ``restore_noise`` injected, and the draws made where they are used
    give equal outputs (3 steps: one cached group of 2 and a trailing step)."""
    cfg = dataclasses.replace(TUR.tiny_config(), **MODES[mode])
    ft, tt = TUR.init(cfg, device="cpu", seed=31)
    sched = TUR.schedule(cfg)
    images = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(32))

    def gen():
        return torch.Generator().manual_seed(33)

    eager = TUR.restore_padded(ft, tt, cfg, sched, images, "seg", gen(), 3, device="cpu")
    post, diff = TUR.restore_noise(cfg, images.shape, images.dtype, gen(), "cpu")
    assert post.shape == diff.shape == (2, 8, 8, cfg.vae.latent_channels)
    injected = TUR.restore_padded(ft, tt, cfg, sched, images, "seg", None, 3, device="cpu",
                                  posterior_noise=post, diffusion_noise=diff)
    in_place = _drawn_in_place(ft, tt, cfg, sched, images, "seg", gen(), 3)
    assert torch.isfinite(eager).all()
    assert torch.equal(eager, injected) and torch.equal(eager, in_place)
    # ``restore`` (resize, pad, crop) draws the same numbers for its padded shape
    small = images[:, :50, :60]
    shape = TUR.padded_shape(small.shape, cfg)
    post, diff = TUR.restore_noise(cfg, shape, small.dtype, gen(), "cpu")
    assert torch.equal(TUR.restore(ft, tt, cfg, sched, small, "ir", gen(), 3, device="cpu"),
                       TUR.restore(ft, tt, cfg, sched, small, "ir", None, 3, device="cpu",
                                   posterior_noise=post, diffusion_noise=diff))


def test_restore_noise_draws_only_what_is_missing():
    """A given tensor is used as is and the generator draws the other one;
    without the Controller there is no diffusion noise."""
    cfg = TUR.tiny_config()
    given = torch.ones((1, 8, 8, 4))
    post, diff = TUR.restore_noise(cfg, (1, 64, 64, 3), torch.float32,
                                   torch.Generator().manual_seed(0), "cpu", posterior_noise=given)
    assert post is given
    assert torch.equal(diff, torch.randn((1, 8, 8, 4), generator=torch.Generator().manual_seed(0)))
    post, diff = TUR.restore_noise(TUR.tiny_config(control_type="none"), (1, 64, 64, 3),
                                   torch.bfloat16, torch.Generator().manual_seed(0), "cpu")
    assert diff is None and post.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="generator"):
        TUR.restore_noise(cfg, (1, 64, 64, 3), torch.float32, None, "cpu", posterior_noise=given)


@pytest.mark.parametrize("mode", ["none", "deep"])
def test_restore_core_matches_jax_restore(mode):
    """The device-only core (what ``GraphedRestore`` captures) on numpy-seeded
    images and the JAX key's noise == JAX ``restore``: a 50 x 70 input resized
    to 64 x 90, padded to 64 x 128, restored, cropped and resized back."""
    kw = dict(cache_mode=mode, cache_stride=2)
    cj = dataclasses.replace(JUR.tiny_config(), **kw)
    ct = dataclasses.replace(TUR.tiny_config(), **kw)
    (fj, tj), (ft, tt) = tiny_pair(cj, ct, seed=34)
    images = np.random.default_rng(35).uniform(size=(1, 50, 70, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(36)
    h, w, ph, pw = JUR.preprocess_shape(50, 70, cj)
    x = JRS.reflect_pad_hw(JRS.resize_bicubic(jnp.asarray(images), (h, w)), ph, pw)
    assert TUR.padded_shape(images.shape, ct) == x.shape
    post, diff = _jax_noise(cj, x.shape, rng)

    sched_j = JUR.schedule(cj)
    ref = jax.jit(lambda f, t, x, r: JUR.restore(f, t, cj, sched_j, x, "cls", r, 3))(
        fj, tj, images, rng)
    out = TUR.restore_core(ft, tt, ct, TUR.schedule(ct), torch.from_numpy(images), "cls",
                           post, diff, 3)
    assert out.shape == (1, 50, 70, 3)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), **TOL)


def test_graphed_restore_refuses_the_cpu(tmp_path):
    cfg = TUR.tiny_config()
    ft, tt = TUR.init(cfg, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        GR.GraphedRestore(ft, tt, cfg, TUR.schedule(cfg), device="cpu")
    args = serve.parse_args(["--tiny", "--device", "cpu", "--cuda-graphs",
                             "--weights-dir", str(tmp_path)])
    with pytest.raises(ValueError, match="CUDA"):
        serve.build_restore(args)


def test_cuda_graphs_are_off_by_default():
    assert serve.parse_args([]).cuda_graphs is False
    assert serve.parse_args(["--cuda-graphs"]).cuda_graphs is True


def test_graph_cache_evicts_the_least_recently_used():
    made = []

    def make(key):
        def stub():  # stands in for a capture
            made.append(key)
            return f"graph {key}"
        return stub

    cache = GR.GraphCache(max_graphs=3)
    for key in "abc":
        assert cache.get(key, make(key)) == f"graph {key}"
    assert cache.get("a", make("a")) == "graph a"  # a hit: no capture, a most recent
    assert made == ["a", "b", "c"] and cache.keys() == ["b", "c", "a"]
    cache.get("d", make("d"))  # full: b, the least recently used, goes
    assert cache.keys() == ["c", "a", "d"]
    cache.get("b", make("b"))  # captured again
    assert made == ["a", "b", "c", "d", "b"] and cache.keys() == ["a", "d", "b"]
    assert GR.GraphCache().max_graphs == GR.MAX_GRAPHS == 16
    with pytest.raises(ValueError):
        GR.GraphCache(max_graphs=0)
