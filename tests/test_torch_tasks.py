"""Port parity: the frozen critics of stage 2 (``unirestore_torch/tasks``),
their resize, their losses, and how the engine builds them.

Both sides run one set of critic weights: the port's seeded ResNet-50 and
DeepLabV3+-ResNet-50 with random BatchNorm statistics and affine leaves (so
the folded inference BN does real work), handed to the JAX functions in the
JAX layout (``bridge.to_numpy_tree``) and carried back across by
``bridge.critics_from_jax``; the trees' keys and shapes are held to the JAX
inits'. Everything runs in fp32 on the CPU.
Tolerances:

- ``resize_bilinear``: 1e-5 absolute on [0, 1] inputs (both compute the
  source positions in float64 and the two taps in fp32);
- ResNet-50 features and logits, DeepLabV3+ logits: 1e-4 of the largest
  reference magnitude (fp32 convolutions summed in another order through 50
  layers);
- the cross-entropy losses on shared logits: 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unirestore_torch import bridge, tasks, zoo
from unirestore_torch.ops import resize as TR
from unirestore_torch.tasks import deeplab as TDL
from unirestore_torch.tasks import resnet as TRN
from unirestore_torch.train import engine as TE
from unirestore_tpu.ops import resize as JR
from unirestore_tpu.tasks import deeplab as JDL
from unirestore_tpu.tasks import resnet as JRN
from unirestore_tpu.train import checkpoints as JCK

torch.set_num_threads(2)


def _randomize_bn(tree, rng):
    """Random running statistics and affine leaves for every BN of a numpy tree."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            c = tree["scale"].shape
            return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                    "bias": (0.1 * rng.standard_normal(c)).astype(np.float32),
                    "mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
        return {k: _randomize_bn(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomize_bn(v, rng) for v in tree]
    return tree


def jax_critics(seed=0):
    """The critics by task as numpy trees in the JAX layout, BN statistics
    randomised: the port's seeded init (the JAX init compiles a program per
    leaf shape, seconds on the CPU), whose keys and shapes
    ``test_critic_trees_have_the_jax_keys_and_shapes`` holds to the JAX
    ``resnet_init`` and ``deeplabv3plus_init``."""
    rng = np.random.default_rng(seed)
    return {task: _randomize_bn(bridge.to_numpy_tree(tasks.critic_init(task, "cpu")), rng)
            for task in ("cls", "seg")}


@pytest.fixture(scope="module")
def critics():
    """(JAX critics as jax arrays, the same carried across to the port)."""
    ref = jax_critics()
    return jax.tree.map(jnp.asarray, ref), bridge.critics_from_jax(ref, device="cpu")


def _close(got, want, scale=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=scale * float(np.abs(want).max()))


@pytest.mark.parametrize("shape,size", [((2, 16, 24, 3), (40, 37)),
                                        ((1, 512, 512, 3), (224, 224)),
                                        ((2, 37, 53, 5), (29, 71))],
                         ids=["up", "512_to_224", "odd"])
def test_resize_bilinear_matches_jax(shape, size):
    x = np.random.default_rng(1).uniform(size=shape).astype(np.float32)
    want = np.asarray(JR.resize_bilinear(jnp.asarray(x), size))
    got = TR.resize_bilinear(torch.from_numpy(x), size).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("output_stride", [8, 16])
def test_resnet_features_match_jax(critics, output_stride):
    jc, tc = critics
    x = np.random.default_rng(2).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    want = JRN.resnet_features(jc["cls"], jnp.asarray(x), output_stride)
    got = TRN.resnet_features(tc["cls"], torch.from_numpy(x), output_stride)
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        _close(got[k], want[k])
    assert got["c5"].shape[1] == 64 // output_stride


def test_resnet50_logits_match_jax(critics):
    jc, tc = critics
    x = np.random.default_rng(3).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    want = JRN.resnet_apply(jc["cls"], jnp.asarray(x))
    got = TRN.resnet_apply(tc["cls"], torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (2, 1000)
    _close(got, want)


def test_deeplabv3plus_logits_match_jax(critics):
    jc, tc = critics
    x = np.random.default_rng(4).uniform(size=(1, 64, 96, 3)).astype(np.float32)
    want = JDL.deeplabv3plus_apply(jc["seg"], jnp.asarray(x))
    got = TDL.deeplabv3plus_apply(tc["seg"], torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (1, 64, 96, 19)
    _close(got, want)
    _close(tasks.critic_apply("seg", tc["seg"], torch.from_numpy(x)), want)


def test_cross_entropy_losses_match_jax():
    rng = np.random.default_rng(5)
    logits = (3 * rng.standard_normal((3, 1000))).astype(np.float32)
    labels = np.array([0, 417, 999])
    want = float(JRN.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = TRN.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels)).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)

    seg = (3 * rng.standard_normal((2, 12, 16, 19))).astype(np.float32)
    lab = rng.integers(0, 19, (2, 12, 16))
    lab[:, :5] = 255  # an ignored region
    want = float(JDL.seg_cross_entropy_loss(jnp.asarray(seg), jnp.asarray(lab)))
    got = TDL.seg_cross_entropy_loss(torch.from_numpy(seg), torch.from_numpy(lab)).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # nothing valid: the mean over max(valid, 1) pixels is 0
    none = np.full_like(lab, 255)
    assert TDL.seg_cross_entropy_loss(torch.from_numpy(seg), torch.from_numpy(none)).item() == 0
    assert float(JDL.seg_cross_entropy_loss(jnp.asarray(seg), jnp.asarray(none))) == 0


def test_critic_trees_have_the_jax_keys_and_shapes():
    shapes = {"cls": jax.eval_shape(lambda k: JRN.resnet_init(k, "resnet50"),
                                    jax.random.PRNGKey(7)),
              "seg": jax.eval_shape(JDL.deeplabv3plus_init, jax.random.PRNGKey(8))}
    for task, tree in shapes.items():
        want = {k: tuple(v.shape) for k, v in JCK.tree_flatten_dict(tree).items()}
        got = bridge.flatten(tasks.critic_init(task, "meta"))
        assert got.keys() == want.keys(), task
        for k, v in got.items():
            shape = tuple(v.shape)
            if v.ndim == 4:  # OIHW here, HWIO there
                shape = (shape[2], shape[3], shape[1], shape[0])
            assert shape == want[k], k
    assert "fc" in tasks.critic_init("cls", "meta")
    assert "fc" not in tasks.critic_init("seg", "meta")["backbone"]
    # the bridge checks both ways
    ref = jax_critics()
    short = dict(ref)
    short["cls"] = {k: v for k, v in ref["cls"].items() if k != "fc"}
    with pytest.raises(KeyError, match="missing"):
        bridge.critics_from_jax(short, device="cpu")
    extra = dict(ref)
    extra["seg"] = {**ref["seg"], "fc": ref["cls"]["fc"]}
    with pytest.raises(KeyError, match="unexpected"):
        bridge.critics_from_jax(extra, device="cpu")


def test_build_critics_loads_converted_weights_or_keeps_the_seeded_init(tmp_path, monkeypatch):
    monkeypatch.setattr(zoo, "_WARNED", set())
    with pytest.warns(UserWarning, match="resnet50_v1"):
        seeded = TE.build_critics("mtl", device="cpu", weights_dir=tmp_path)
    assert seeded.keys() == {"cls", "seg"}
    again = TE.build_critics("cls", device="cpu", weights_dir=tmp_path)
    assert again.keys() == {"cls"}
    for k, v in bridge.flatten(again["cls"]).items():
        assert torch.equal(v, bridge.flatten(seeded["cls"])[k]), k
    assert TE.build_critics("ir", device="cpu") == {}

    # a converted file (the JAX layout, flat //-keys) is read into the tree
    ref = jax_critics(seed=9)
    np.savez(tmp_path / "deeplabv3plus_resnet50.npz", **JCK.tree_flatten_dict(ref["seg"]))
    loaded = TE.build_critics("seg", device="cpu", weights_dir=tmp_path)["seg"]
    want = bridge.flatten(bridge.critics_from_jax({"seg": ref["seg"]}, device="cpu")["seg"])
    for k, v in bridge.flatten(loaded).items():
        assert v.dtype == torch.float32 and torch.equal(v, want[k]), k

    with pytest.raises(NotImplementedError, match="Queue A 5"):
        TE.build_critics("det", device="cpu")
    with pytest.raises(NotImplementedError, match="Queue A 5"):
        TE.make_te_loss_fn("det", {})
    with pytest.raises(NotImplementedError, match="Queue A 5"):
        TDL.deeplab_factory("deeplabv3plus_mobilenet")
    with pytest.raises(ValueError, match="unknown"):
        TDL.deeplab_factory("deeplabv3plus_vgg")


def test_te_loss_fn_weights_the_tasks_like_jax(critics):
    """The mtl task loss: 10 L1 on ir, 0.1 CE through each critic on cls and
    seg; the single-task engines unweighted (``make_te_loss_fn``)."""
    from unirestore_tpu.train import engine as JE

    jc, tc = critics
    rng = np.random.default_rng(6)
    preds = rng.uniform(size=(1, 64, 64, 3)).astype(np.float32)
    hq = rng.uniform(size=(1, 64, 64, 3)).astype(np.float32)
    gts = {"ir": None, "cls": np.array([3]),
           "seg": rng.integers(0, 19, (1, 64, 64))}
    for etype, task in (("mtl", "ir"), ("mtl", "cls"), ("mtl", "seg"), ("ir", "ir"),
                        ("cls", "cls"), ("seg", "seg")):
        gt = gts[task]
        want = float(JE.make_te_loss_fn(etype, jc)(
            jnp.asarray(preds), jnp.asarray(hq), None if gt is None else jnp.asarray(gt), task))
        got = TE.make_te_loss_fn(etype, tc)(
            torch.from_numpy(preds), torch.from_numpy(hq),
            None if gt is None else torch.from_numpy(gt), task).item()
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=f"{etype} {task}")
    with pytest.raises(KeyError):
        TE.make_te_loss_fn("mtl", tc)(torch.from_numpy(preds), torch.from_numpy(hq), None, "det")
