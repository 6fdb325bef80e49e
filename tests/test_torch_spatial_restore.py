"""Port parity: the encoder and ``restore_padded`` on height-sharded batches
(``parallel.make_mesh_2d`` / ``spatial_batch_sharding``) against the JAX
functions on one device.

The tiny config's seeded init with its all-zero leaves filled
(``tests/test_torch_eval.py:filled_init``), 128 px images (at 64 px the
UNet's coarsest map is one row high, which two ranks cannot split), JAX's
noise recomputed from its key and injected (``tests/test_torch_pipeline.py``):

- on ``make_mesh_2d(1, 2)`` (two gloo ranks, each half of the height of a
  batch of 2): the assembled ``encode`` latents and skips against JAX's
  ``encode`` at 1e-5 (the tolerance of JAX's own
  ``test_spatially_sharded_encode_matches_single_device``); the assembled
  ``restore_padded`` (two DDIM steps, stride 2: a key step and its follower)
  in the exact, ``encoder`` and ``deep`` cache modes and exact with the
  out-projection-fused route against JAX's ``restore_padded`` at 2e-4 (the
  whole-restore tolerance);
- on ``make_mesh_2d(2, 2)`` (four ranks, batch 4: rows over ``data``, height
  over ``spatial``) the exact restore, assembled, at 2e-4; and a 64 px batch
  on ``make_mesh_2d(1, 4)`` refused, naming the UNet level one row cannot
  split.

The exact JAX restore runs once at batch 4; the batch-2 runs hold their
output to its first two rows (each row's restore reads only its own image
and noise). The ranks run while this process computes the JAX references;
they import neither JAX nor the JAX package.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_spatial import (RES, RESTORE_TOL, STEPS, finish_ranks, port_trees,
                                sharded_restore, start_ranks)
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
BATCH = 4


def _cfg(mode="none"):
    return dataclasses.replace(TUR.tiny_config(), **MODES[mode])


def _two_ranks(rank, world, payload):
    sharding = MESH.spatial_batch_sharding(MESH.make_mesh_2d(1, world))
    cfg = _cfg()
    trees = port_trees(payload, cfg)
    images, (post, diff) = payload["images"][:2], (n[:2] for n in payload["noise"])
    ctx = sharding.context(RES)
    with torch.inference_mode(), SP.partition(ctx):
        z, skips = TUR.encode(*trees, cfg, sharding.local(torch.from_numpy(images)),
                              noise=sharding.local(torch.from_numpy(post)))
    res = {"encode": [sharding.assemble(t).numpy() for t in (z, *skips)],
           "encode_counts": dict(ctx.counts)}
    for mode in MODES:
        res[mode] = sharded_restore(sharding, trees, _cfg(mode), images, "ir", (post, diff))
    return res


def _four_ranks(rank, world, payload):
    sharding = MESH.spatial_batch_sharding(MESH.make_mesh_2d(2, 2))
    cfg = _cfg()
    res = {"coordinate": sharding.coordinate,
           "none": sharded_restore(sharding, port_trees(payload, cfg), cfg, payload["images"],
                                   "ir", payload["noise"])}
    narrow = MESH.spatial_batch_sharding(MESH.make_mesh_2d(1, world))
    try:
        TUR.restore_padded(*port_trees(payload, cfg), cfg, TUR.schedule(cfg),
                           narrow.local(torch.zeros(1, 64, 64, 3)), "ir",
                           torch.Generator().manual_seed(0), STEPS, device="cpu",
                           sharding=narrow)
    except ValueError as e:
        res["uneven_error"] = str(e)
    return res


def _reference():
    """The payload (trees in the JAX layout, a batch of 4 and its JAX noise)
    and a function computing the JAX references: ``encode`` of the first two
    images, the exact restore of all four and the cached modes of the first two."""
    import jax
    import jax.numpy as jnp

    from test_torch_eval import filled_init
    from test_torch_pipeline import _jax_noise
    from unirestore_tpu.models import unirestore as JUR

    trees = tuple(bridge.to_numpy_tree(t) for t in filled_init(_cfg(), seed=41))
    images = np.random.default_rng(42).uniform(size=(BATCH, RES, RES, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(43)
    noise = tuple(n.numpy() for n in _jax_noise(JUR.tiny_config(), images.shape, rng))

    def reference():
        fj, tj = (jax.tree.map(jnp.asarray, t) for t in trees)
        k_enc, _ = jax.random.split(rng)
        z, skips = jax.jit(lambda f, t, x: JUR.encode(f, t, JUR.tiny_config(), x, rng=k_enc))(
            fj, tj, images[:2])
        out = {"encode": [np.asarray(a) for a in (z, *skips)]}
        for mode, x in (("none", images), ("encoder", images[:2]), ("deep", images[:2])):
            cj = dataclasses.replace(JUR.tiny_config(), **MODES[mode])
            sched = JUR.schedule(cj)
            out[mode] = np.asarray(jax.jit(lambda f, t, x, r: JUR.restore_padded(
                f, t, cj, sched, x, "ir", r, STEPS))(fj, tj, x, rng))
        return out

    return {"trees": trees, "images": images, "noise": noise}, reference


@pytest.fixture(scope="module")
def spatial_runs(tmp_path_factory):
    payload, reference = _reference()
    two = start_ranks(_two_ranks, tmp_path_factory.mktemp("spatial2"), payload, world=2)
    four = start_ranks(_four_ranks, tmp_path_factory.mktemp("spatial4"), payload, world=4)
    ref = reference()  # while the ranks run
    return {"two": finish_ranks(two), "four": finish_ranks(four), "jax": ref}


def test_sharded_encode_matches_jax(spatial_runs):
    got = spatial_runs["two"][0]["encode"]
    for a, b in zip(got, spatial_runs["jax"]["encode"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **ENCODE_TOL)
    np.testing.assert_array_equal(got[0], spatial_runs["two"][1]["encode"][0])
    counts = spatial_runs["two"][0]["encode_counts"]
    assert counts["halo"] and counts["all_reduce"] and counts["all_gather"], counts


@pytest.mark.parametrize("mode", list(MODES))
def test_sharded_restore_on_mesh_1x2_matches_jax(mode, spatial_runs):
    (out, counts), (out1, _) = (r[mode] for r in spatial_runs["two"])
    np.testing.assert_array_equal(out, out1)
    ref = spatial_runs["jax"]["none" if mode == "fused" else mode][:2]
    assert out.shape == (2, RES, RES, 3)
    np.testing.assert_allclose(out, ref, **RESTORE_TOL)
    assert counts["halo"] and counts["all_reduce"] and counts["all_gather"], counts


def test_sharded_restore_on_mesh_2x2_matches_jax(spatial_runs):
    ranks = spatial_runs["four"]
    assert [r["coordinate"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    outs = [r["none"][0] for r in ranks]
    for out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0])
    assert outs[0].shape == (BATCH, RES, RES, 3)
    np.testing.assert_allclose(outs[0], spatial_runs["jax"]["none"], **RESTORE_TOL)


def test_uneven_spatial_shards_are_refused(spatial_runs):
    msg = spatial_runs["four"][0]["uneven_error"]
    assert "over 4 ranks: the UNet level 2 (latent / 4) is 2 rows high" in msg, msg
