"""Port parity: uneven spatial shards and the whole ``restore`` on the 2-D
(data, spatial) mesh, against the JAX functions on one device.

A level of the restore whose rows the spatial ranks cannot split into equal,
even slabs runs whole on every rank from there down (``models/unirestore.py:
spatial_plan``, ``parallel/spatial.py``); GSPMD pads such a level instead, and
both compute the single-device function. The tiny config's seeded init with
its all-zero leaves filled (``tests/test_torch_eval.py:filled_init``), JAX's
noise recomputed from its key and injected (``tests/test_torch_pipeline.py``):

- JAX's own shape (``tests/test_train.py:test_spatially_sharded_encode_matches_single_device``):
  64 px, batch 2, ``make_mesh_2d(2, 4)`` (eight gloo ranks; the UNet's 2-row
  and 1-row levels run whole): the assembled ``encode`` against JAX's
  ``encode`` at 1e-5, the assembled ``restore_padded`` (two DDIM steps)
  against JAX's ``restore_padded`` at 2e-4;
- 64 px on ``make_mesh_2d(1, 2)`` (the 1-row level runs whole) in the exact,
  ``encoder``, ``deep`` and fused modes at 2e-4;
- ``restore(..., sharding=)`` on ``(1, 2)`` with 100 x 40 originals (resized
  to 160 x 64, padded to 192: the 3-row level runs whole) and on ``(1, 3)``
  with 96 x 64 originals (padded to 128, which three ranks cannot split: every
  level runs whole) against JAX's ``restore`` at 2e-4;
- each case's first whole level and its collective counts per rank, pinned.

The ranks run while this process computes the JAX references; they import
neither JAX nor the JAX package.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_spatial import (RESTORE_TOL, STEPS, finish_ranks, port_trees, sharded_restore,
                                start_ranks)
from unirestore_torch import bridge
from unirestore_torch.models import unirestore as TUR
from unirestore_torch.parallel import mesh as MESH
from unirestore_torch.parallel import spatial as SP

torch.set_num_threads(2)
ENCODE_TOL = dict(atol=1e-5, rtol=1e-5)
MODES = {"none": dict(cache_mode="none"), "fused": dict(cache_mode="none",
                                                        fused_out_attention=True),
         "encoder": dict(cache_mode="encoder", cache_stride=2),
         "deep": dict(cache_mode="deep", cache_stride=2)}
RES = 64
# (height, width) of the originals of the two sharded ``restore`` cases
ORIGINALS = {"restore_1x2": (100, 40), "restore_1x3": (96, 64)}
# the first whole level of each case
WHOLE = {"mesh_2x4": "UNet level 2 (latent / 4)", "mesh_1x2": "UNet level 3 (latent / 8)",
         "restore_1x2": "UNet level 3 (latent / 8)", "restore_1x3": "image"}
# collectives per rank and restore (two DDIM steps), by kind: (halo,
# all_reduce, all_gather). A whole level issues none; each crossing into one
# gathers once, and the sharded ``restore`` gathers its originals and, where
# the padded image splits, its padded output.
COUNTS = {"mesh_2x4_encode": (35, 38, 1), "mesh_2x4": (162, 189, 34),
          "mesh_1x2": {"none": (200, 235, 48), "fused": (200, 235, 48),
                       "encoder": (164, 193, 34), "deep": (155, 181, 30)},
          "restore_1x2": (200, 235, 50), "restore_1x3": (0, 0, 1)}


def _cfg(mode="none"):
    return dataclasses.replace(TUR.tiny_config(), **MODES[mode])


def _counts(ctx) -> tuple:
    return tuple(ctx.counts[k] for k in SP.COLLECTIVES)


def _sharded_full_restore(sharding, trees, cfg, images, noise):
    """``restore`` of this rank's block of the originals with the global noise
    of the padded batch; (the assembled output, the first whole level, the
    collective counts)."""
    out = TUR.restore(*trees, cfg, TUR.schedule(cfg), sharding.local(torch.from_numpy(images)),
                      "ir", None, STEPS, posterior_noise=torch.from_numpy(noise[0]),
                      diffusion_noise=torch.from_numpy(noise[1]), device="cpu",
                      sharding=sharding)
    ctx = sharding.last_context
    return sharding.assemble(out).numpy(), ctx.whole_level, _counts(ctx)


def _mesh_2x4(rank, world, payload):
    sharding = MESH.spatial_batch_sharding(MESH.make_mesh_2d(2, 4))
    cfg = _cfg()
    trees = port_trees(payload, cfg)
    images, (post, diff) = payload["images"], payload["noise"]
    ctx = TUR.spatial_context(cfg, sharding, RES)
    split = not ctx.runs_whole(ctx.latent_depth)
    with torch.inference_mode(), SP.partition(ctx):
        z, skips = TUR.encode(*trees, cfg, sharding.local(torch.from_numpy(images)),
                              noise=sharding.local(torch.from_numpy(post), split))
    res = {"coordinate": sharding.coordinate,
           "encode": [sharding.assemble(t).numpy() for t in (z, *skips)],
           "encode_counts": _counts(ctx)}
    out, _ = sharded_restore(sharding, trees, cfg, images, "ir", (post, diff))
    ctx = sharding.last_context
    res["none"] = (out, ctx.whole_level, _counts(ctx))
    return res


def _mesh_1x2(rank, world, payload):
    sharding = MESH.spatial_batch_sharding(MESH.make_mesh_2d(1, 2))
    res = {}
    for mode in MODES:
        cfg = _cfg(mode)
        out, _ = sharded_restore(sharding, port_trees(payload, cfg), cfg, payload["images"], "ir",
                                 payload["noise"])
        ctx = sharding.last_context
        res[mode] = (out, ctx.whole_level, _counts(ctx))
    res["restore_1x2"] = _sharded_full_restore(sharding, port_trees(payload, _cfg()), _cfg(),
                                               *payload["restore_1x2"])
    return res


def _mesh_1x3(rank, world, payload):
    sharding = MESH.spatial_batch_sharding(MESH.make_mesh_2d(1, 3))
    return {"restore_1x3": _sharded_full_restore(sharding, port_trees(payload, _cfg()), _cfg(),
                                                 *payload["restore_1x3"])}


def _reference():
    """The payload (trees in the JAX layout, a 64 px batch of 2 and its JAX
    noise, the originals of the two ``restore`` cases and the JAX noise of
    their padded batches) and a function computing the JAX references."""
    import jax
    import jax.numpy as jnp

    from test_torch_eval import filled_init
    from test_torch_pipeline import _jax_noise
    from unirestore_tpu.models import unirestore as JUR

    trees = tuple(bridge.to_numpy_tree(t) for t in filled_init(_cfg(), seed=51))
    rng = jax.random.PRNGKey(53)
    images = np.random.default_rng(52).uniform(size=(2, RES, RES, 3)).astype(np.float32)
    payload = {"trees": trees, "images": images,
               "noise": tuple(n.numpy() for n in _jax_noise(JUR.tiny_config(), images.shape, rng))}
    for seed, (name, hw) in enumerate(ORIGINALS.items(), 54):
        org = np.random.default_rng(seed).uniform(size=(2, *hw, 3)).astype(np.float32)
        noise = _jax_noise(JUR.tiny_config(), TUR.padded_shape(org.shape, _cfg()), rng)
        payload[name] = (org, tuple(n.numpy() for n in noise))

    def reference():
        fj, tj = (jax.tree.map(jnp.asarray, t) for t in trees)
        k_enc, _ = jax.random.split(rng)
        z, skips = jax.jit(lambda f, t, x: JUR.encode(f, t, JUR.tiny_config(), x, rng=k_enc))(
            fj, tj, images)
        out = {"encode": [np.asarray(a) for a in (z, *skips)]}
        for mode in ("none", "encoder", "deep"):
            cj = dataclasses.replace(JUR.tiny_config(), **MODES[mode])
            sched = JUR.schedule(cj)
            out[mode] = np.asarray(jax.jit(lambda f, t, x, r: JUR.restore_padded(
                f, t, cj, sched, x, "ir", r, STEPS))(fj, tj, images, rng))
        cj = JUR.tiny_config()
        sched = JUR.schedule(cj)
        full = jax.jit(lambda f, t, x, r: JUR.restore(f, t, cj, sched, x, "ir", r, STEPS))
        for name in ORIGINALS:
            out[name] = np.asarray(full(fj, tj, payload[name][0], rng))
        return out

    return payload, reference


@pytest.fixture(scope="module")
def uneven_runs(tmp_path_factory):
    payload, reference = _reference()
    started = {name: start_ranks(body, tmp_path_factory.mktemp(name), payload, world=world)
               for name, body, world in (("mesh_2x4", _mesh_2x4, 8), ("mesh_1x2", _mesh_1x2, 2),
                                         ("mesh_1x3", _mesh_1x3, 3))}
    ref = reference()  # while the ranks run
    return {"jax": ref, **{name: finish_ranks(s) for name, s in started.items()}}


def _same_on_every_rank(ranks, key):
    """The assembled output (equal on every rank), the first whole level and
    the counts (each the same on every rank)."""
    out, whole, counts = ranks[0][key]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key][0], out)
        assert r[key][1:] == (whole, counts), (r[key][1:], whole, counts)
    return out, whole, counts


def test_jax_mesh_2x4_encode_matches_jax(uneven_runs):
    ranks = uneven_runs["mesh_2x4"]
    assert [r["coordinate"] for r in ranks] == [(d, s) for d in range(2) for s in range(4)]
    got = ranks[0]["encode"]
    for a, b in zip(got, uneven_runs["jax"]["encode"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **ENCODE_TOL)
    assert all(r["encode_counts"] == COUNTS["mesh_2x4_encode"] for r in ranks), \
        [r["encode_counts"] for r in ranks]


def test_jax_mesh_2x4_restore_padded_matches_jax(uneven_runs):
    out, whole, counts = _same_on_every_rank(uneven_runs["mesh_2x4"], "none")
    assert out.shape == (2, RES, RES, 3)
    np.testing.assert_allclose(out, uneven_runs["jax"]["none"], **RESTORE_TOL)
    assert (whole, counts) == (WHOLE["mesh_2x4"], COUNTS["mesh_2x4"])


@pytest.mark.parametrize("mode", list(MODES))
def test_uneven_restore_on_mesh_1x2_matches_jax(mode, uneven_runs):
    out, whole, counts = _same_on_every_rank(uneven_runs["mesh_1x2"], mode)
    assert out.shape == (2, RES, RES, 3)
    np.testing.assert_allclose(out, uneven_runs["jax"]["none" if mode == "fused" else mode],
                               **RESTORE_TOL)
    assert (whole, counts) == (WHOLE["mesh_1x2"], COUNTS["mesh_1x2"][mode])


@pytest.mark.parametrize("name", list(ORIGINALS))
def test_sharded_restore_matches_jax(name, uneven_runs):
    ranks = uneven_runs["mesh_1x2" if name == "restore_1x2" else "mesh_1x3"]
    out, whole, counts = _same_on_every_rank(ranks, name)
    assert out.shape == (2, *ORIGINALS[name], 3)
    np.testing.assert_allclose(out, uneven_runs["jax"][name], **RESTORE_TOL)
    assert (whole, counts) == (WHOLE[name], COUNTS[name])


# -- this process: the plan's suspension of the context -------------------------------


def test_whole_levels_suspend_the_context():
    """``level`` suspends the context at the plan's whole levels and sets it
    again after; ``descend`` and ``ascend`` issue no collective where both
    levels split, or where both run whole."""
    ctx = SP.SpatialContext(group=None, index=1, size=2, height=64, first_whole=5,
                            latent_depth=3)
    x = torch.arange(8.0).reshape(1, 8, 1, 1)
    with SP.partition(ctx):
        for k, latent, whole in ((4, False, False), (5, False, True), (1, True, False),
                                 (2, True, True), (3, True, True)):
            with SP.level(k, latent=latent):
                assert (SP.current() is None) == whole, (k, latent)
            assert SP.current() is ctx
        assert SP.descend(lambda t: t[:, ::2], x, 1, latent=True).shape[1] == 4
        assert SP.descend(lambda t: t[:, ::2], x, 3, latent=True).shape[1] == 4
        up = SP.ascend(lambda t: t.repeat_interleave(2, 1), x, 2, latent=True)
        assert up.shape[1] == 16  # level 2 runs whole: the whole output
        # out of the last whole level into one that splits: rank 1's rows
        assert torch.equal(SP.ascend(lambda t: t.repeat_interleave(2, 1), x, 1, latent=True),
                           x.repeat_interleave(2, 1)[:, 8:])
        with SP.whole():
            assert SP.current() is None
        assert SP.current() is ctx
    assert SP.current() is None
    assert ctx.counts == dict.fromkeys(SP.COLLECTIVES, 0)
