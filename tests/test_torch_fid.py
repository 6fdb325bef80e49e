"""Port parity: FID (``unirestore_torch/evalx/fid.py``) and its InceptionV3
extractor (``evalx/inception.py``), against ``unirestore_tpu/evalx``.

- ``FIDStats``, ``frechet_distance`` and ``FID.compute``: bit-equal on the same
  features (copies of the JAX code, float64 on the host); ``real_frozen`` as
  ``tests/test_metrics.py:94-105`` requires.
- InceptionV3 pool3 features: one tree on both sides (the port's seeded tree
  in the JAX layout, carried back by ``bridge.nr_from_jax``), the JAX function
  run eagerly, both in fp32 on the CPU: max abs within 1e-4 of the largest
  |feature|, and a second input (a smooth ramp) moves them by more than 100
  times that. The seeded tree is compared as it is: its convolutions have no
  bias and the unit BatchNorm statistics leave the network homogeneous, so
  the features are small (about 1e-7) but the input reaches them; BatchNorm
  statistics from the batch (as ``tests/test_torch_nr_suite.py`` sets them
  for the networks whose seeded init erases the input) make these layers
  without residual scaling amplify the summation order to 1e-4 and more.
  ``make_fid_extractor`` loads ``inception_v3.npz`` (the JAX tree, flat) from
  its weights directory.
- The IR evaluator in ALL with ``compute_fid`` through ``config.build``: the
  keys ``val_{hq,lq}/fid``, real features kept across epochs.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_nr_suite import ramp
from unirestore_torch import bridge
from unirestore_torch import config as TC
from unirestore_torch.evalx import fid as TF
from unirestore_torch.evalx import inception as TINC
from unirestore_tpu.evalx import fid as JF
from unirestore_tpu.evalx import inception as JINC
from unirestore_tpu.train import checkpoints as JCK

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-4


@pytest.mark.parametrize("dim,n", [(8, 500), (64, 40)], ids=["tall", "rank_deficient"])
def test_frechet_distance_bit_equal(dim, n):
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(n, dim)), 0.5 + 1.3 * rng.normal(size=(n, dim))
    stats = []
    for mod in (TF, JF):
        s1, s2 = mod.FIDStats(dim), mod.FIDStats(dim)
        s1.update(a[: n // 2])
        s1.update(a[n // 2:])
        s2.update(b)
        stats.append((s1.finalize(), s2.finalize()))
    (t1, t2), (j1, j2) = stats
    for got, want in zip((*t1, *t2), (*j1, *j2)):
        np.testing.assert_array_equal(got, want)
    got = TF.frechet_distance(*t1, *t2)
    assert got == JF.frechet_distance(*j1, *j2) and got > 0
    assert TF.frechet_distance(*t1, *t1) == pytest.approx(0.0, abs=1e-6)


def test_fid_real_feature_caching_like_jax():
    extract = lambda x: x.reshape(len(x), -1)[:, :8]  # noqa: E731
    rng = np.random.default_rng(0)
    feeds = [(rng.normal(size=(16, 8, 1, 1)), real) for real in (True, False)]
    late = [(rng.normal(size=(16, 8, 1, 1)), real) for real in (True, False)]
    fids = [mod.FID(extractor=extract, dim=8) for mod in (TF, JF)]
    for fid in fids:
        for x, real in feeds:
            fid.update(x, real=real)
    assert fids[0].compute() == fids[1].compute()
    for fid in fids:
        fid.reset(reset_real_features=False)
        assert fid.real.n == 16 and fid.fake.n == 0 and fid.real_frozen
        # the real statistics are frozen: validation_step feeds the targets
        # again each epoch, and duplicates must not pile up
        for x, real in late:
            fid.update(x, real=real)
        assert fid.real.n == 16 and fid.fake.n == 16
    assert fids[0].compute() == fids[1].compute()
    fids[0].reset(reset_real_features=True)
    assert fids[0].real.n == 0 and not fids[0].real_frozen


@pytest.fixture(scope="module")
def inception_pair():
    """(the seeded tree in the JAX layout, input, ramp, JAX features of both)."""
    shape = (2, 48, 48, 3)
    tree = bridge.to_numpy_tree(bridge.nr_init("inception", "cpu"))
    x = np.random.default_rng(1).uniform(size=shape).astype(np.float32)
    jt = jax.tree.map(jnp.asarray, tree)
    x2 = ramp(shape)
    return tree, x, x2, [np.asarray(JINC.inception_v3_features(jt, jnp.asarray(v)))
                         for v in (x, x2)]


def test_inception_features_match_jax(inception_pair):
    tree, x, _, (want, want2) = inception_pair
    port = bridge.nr_from_jax({"inception": tree}, device="cpu")["inception"]
    with torch.inference_mode():
        got = TINC.inception_v3_features(port, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, TINC.DIM)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)
    assert float(np.abs(want2 - want).max()) > 100 * RTOL * scale


def test_fid_extractor_loads_the_npz(inception_pair, tmp_path):
    tree, x, _, (want, _) = inception_pair
    flat = JCK.tree_flatten_dict(tree)
    np.savez(tmp_path / "inception_v3.npz", **flat)
    extract, dim = TINC.make_fid_extractor(device="cpu", weights_dir=tmp_path)
    assert dim == 2048
    assert bridge.flatten(bridge.to_numpy_tree(extract.params)).keys() == flat.keys()
    got = extract(x)
    assert got.dtype == np.float32 and got.shape == (2, 2048)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * float(np.abs(want).max()))


def test_inception_tree_has_the_jax_keys_and_shapes():
    port = {}
    for k, v in bridge.flatten(bridge.nr_init("inception", "meta")).items():
        s = tuple(v.shape)
        port[k] = (s[2], s[3], s[1], s[0]) if k.split("//")[-1] == "w" and len(s) == 4 else s
    tree = jax.eval_shape(JINC.inception_v3_init, jax.random.PRNGKey(0))
    assert port == {k: tuple(v.shape) for k, v in JCK.tree_flatten_dict(tree).items()}


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    for name in ("tensorflow", "torch.utils.tensorboard"):
        monkeypatch.setitem(sys.modules, name, None)


def test_all_mode_fid_through_build(monkeypatch):
    """``config.build`` in ALL with ``compute_fid`` wires one FID a eval_type
    over the seeded Inception extractor (2048-d) on the engine's device, built
    once across validate() epochs. The epochs then run with the extractor
    swapped for a 3-d one (a 2048-d ``sqrtm`` takes seconds on the CPU): the
    keys ``val_{hq,lq}/fid`` beside the rest, and the real features kept (one
    extractor call a restore in the second epoch, two in the first)."""
    cfg = TC.load_config(REPO / "configs" / "val.yaml",
                         ["--model.init_args.eval_mode", "ALL",
                          "--model.init_args.compute_fid", "true",
                          "--model.init_args.nr_metrics", "[niqe]"])
    engine, _, _, factory = TC.build(cfg, tiny=True, device="cpu")
    ev = factory(engine)
    assert set(ev.fid) == {"hq", "lq"} and ev.fid["hq"] is not ev.fid["lq"]
    extractor = ev.fid["lq"].extractor
    assert ev.fid["hq"].extractor is extractor and ev.fid["lq"].real.dim == TINC.DIM
    assert bridge.flatten(extractor.params).keys() == bridge.flatten(
        bridge.nr_init("inception", "meta")).keys()
    assert extractor(np.full((1, 40, 40, 3), 0.5, np.float32)).shape == (1, TINC.DIM)
    calls = []
    for fid in ev.fid.values():
        fid.real, fid.fake = TF.FIDStats(3), TF.FIDStats(3)
        fid.extractor = lambda x: (calls.append(len(x)), np.asarray(x).mean(axis=(1, 2)))[1]
    rng = np.random.default_rng(2)
    batches = [{"hq": rng.uniform(size=(1, 96, 128, 3)).astype(np.float32),
                "lq": rng.uniform(size=(1, 96, 128, 3)).astype(np.float32)} for _ in range(3)]
    outs = []
    for _ in range(2):
        ev = factory(engine)
        ev.restore_fn = lambda imgs, task: np.clip(0.8 * imgs + 0.1, 0, 1)
        for b in batches:
            ev.validation_step(b)
        outs.append((ev.epoch_end(), len(calls)))
    (first, n1), (second, n2) = outs
    want = {f"val_{e}/{k}" for e in ("hq", "lq") for k in ("psnr", "ssim", "lpips", "fid", "niqe")}
    assert set(first) == set(second) == want | {"val_monitor"}
    assert n1 == 2 * 2 * len(batches) and n2 - n1 == 2 * len(batches)
    assert first["val_lq/fid"] == pytest.approx(second["val_lq/fid"], rel=1e-9)
    assert all(np.isfinite(v) for v in first.values()) and first["val_lq/fid"] > 0
