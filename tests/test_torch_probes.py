"""Port parity: the probe zoos of the ``cls`` and ``seg`` engines
(``unirestore_torch/tasks/``: ``vgg``, ``vit``, ``rvt``, ``swin``,
``convnext``, ``efficientnet``, ``refinenet``, ``classifier_zoo``,
``seg_zoo``) and ``ops/resize.py:resize_bilinear_ac``.

Every probe of ``classifier_zoo._SPECS`` and both segmentation probes run
one set of weights on both sides: the port's seeded tree with its BatchNorm
affines, layer scales, class token, logit scales and attention masks
randomised, cut in depth (block lists sliced; published widths kept), its
BatchNorm statistics set to the test batch's own (``calibrate_bn``: with the
seeded init's unit statistics a deep net's logits are its head's bias), handed
to the JAX function in the JAX layout (``bridge.to_numpy_tree``) and carried
back by ``bridge.probes_from_jax`` with the same cut. Inputs are the small
ones of ``tests/test_classifier_zoo.py`` (Swin v2 at 64 px without
preprocessing: window padding and the no-shift case; Swin v1 at 56 px) and
64 x 96 for the segmentation probes. Everything runs in fp32 on the CPU.
Tolerances:

- logits within 1e-4 of the largest |logit| of the JAX function (fp32
  convolutions and matmuls summed in another order through the network);
- ``resize_bilinear_ac``: 1e-6 absolute on [0, 1] inputs (both compute the
  positions in float64 and the two taps in fp32);
- the Swin tables and shift mask: exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unirestore_torch import bridge, zoo
from unirestore_torch.ops import resize as TR
from unirestore_torch.tasks import classifier_zoo as TCZ
from unirestore_torch.tasks import convnext as TCNX
from unirestore_torch.tasks import deeplab as TDL
from unirestore_torch.tasks import efficientnet as TEFF
from unirestore_torch.tasks import refinenet as TRFN
from unirestore_torch.tasks import resnet as TRN
from unirestore_torch.tasks import seg_zoo as TSZ
from unirestore_torch.tasks import swin as TSW
from unirestore_tpu.ops import resize as JR
from unirestore_tpu.tasks import classifier_zoo as JCZ
from unirestore_tpu.tasks import convnext as JCNX
from unirestore_tpu.tasks import deeplab as JDL
from unirestore_tpu.tasks import efficientnet as JEFF
from unirestore_tpu.tasks import refinenet as JRFN
from unirestore_tpu.tasks import resnet as JRN
from unirestore_tpu.tasks import seg_zoo as JSZ
from unirestore_tpu.tasks import swin as JSW
from unirestore_tpu.train import checkpoints as JCK

torch.set_num_threads(2)

SEG = ("dlv3pr50", "rflwr101")
PROBES = tuple(TCZ._SPECS) + SEG


def _apply_pair(name):
    """(JAX apply, port apply, input shape) of a probe in this test: the zoo's
    apply with its preprocessing, or the module function without it."""
    if name in SEG:
        if name == "dlv3pr50":
            return JDL.deeplabv3plus_apply, TDL.deeplabv3plus_apply, (1, 64, 96, 3)
        return JRFN.refinenet_lw_apply, TRFN.refinenet_lw_apply, (1, 64, 96, 3)
    raw = {"r18": (JRN.resnet_apply, TRN.resnet_apply, (1, 64, 64, 3)),
           "cub_r18": (JRN.resnet_apply, TRN.resnet_apply, (1, 64, 64, 3)),
           "cub_conv": (JCNX.convnext_base_apply, TCNX.convnext_base_apply, (1, 64, 64, 3)),
           "eff": (JEFF.efficientnet_v2_l_apply, TEFF.efficientnet_v2_l_apply, (1, 64, 64, 3)),
           "swin": (lambda p, x, **k: JSW.swin_base_apply(p, x, v2=True, **k),
                    lambda p, x, **k: TSW.swin_base_apply(p, x, v2=True, **k), (1, 64, 64, 3)),
           "cub_swin": (lambda p, x, **k: JSW.swin_base_apply(p, x, v2=False, **k),
                        lambda p, x, **k: TSW.swin_base_apply(p, x, v2=False, **k),
                        (1, 56, 56, 3))}
    if name in raw:
        japply, tapply, shape = raw[name]
        return (lambda p, x: japply(p, x, preprocess_input=False),
                lambda p, x: tapply(p, x, preprocess_input=False), shape)
    shape = {"vgg": (1, 32, 32, 3), "vit": (2, 64, 64, 3), "cub_vitb": (2, 64, 64, 3),
             "rvt": (1, 64, 64, 3)}.get(name, (1, 48, 48, 3))
    return JCZ._SPECS[name][1], TCZ._SPECS[name][1], shape


def cut(name, tree):
    """The probe's tree with its block lists sliced: transformer and Swin stages
    at 2 blocks (RVT one masked and one unmasked block), ConvNeXt, ResNet and
    VGG stages at their first blocks, each EfficientNet stage at its first."""
    t = dict(tree)
    if name in ("vit", "cub_vitb"):
        t["blocks"] = t["blocks"][:2]
    elif name == "rvt":
        t["blocks"] = t["blocks"][4:6]
    elif name in ("swin", "cub_swin", "cub_conv"):
        t["stages"] = [s[:2] for s in t["stages"]]
    elif name == "eff":
        t["stages"] = [s[:1] for s in t["stages"]]
    elif name == "vgg":
        t["features"] = [s[:1] for s in t["features"]]
    elif name in SEG:
        t["backbone"] = {**t["backbone"], "layers": [s[:2] for s in t["backbone"]["layers"]]}
    else:  # the ResNets
        t["layers"] = [s[:2] for s in t["layers"]]
    return t


def _randomize(tree, rng):
    """Random values for the leaves a seeded init leaves trivial: BatchNorm
    statistics and affines, ConvNeXt's layer scale (1e-6), ViT's class token
    (zero), Swin v2's logit scale (log 10; some heads past the log 100 clamp),
    RVT's attention masks (a stronger gate)."""
    if isinstance(tree, list):
        return [_randomize(v, rng) for v in tree]
    if not isinstance(tree, dict):
        return tree
    if set(tree) == {"scale", "bias", "mean", "var"}:
        c = tree["scale"].shape
        return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(c)).astype(np.float32),
                "mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    out = {}
    for k, v in tree.items():
        if k == "gamma":
            v = rng.uniform(0.1, 0.5, v.shape).astype(np.float32)
        elif k == "cls_token":
            v = (0.5 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k == "logit_scale":
            v = rng.uniform(1.0, 5.0, v.shape).astype(np.float32)
        elif k == "att_mask":
            v = rng.standard_normal(v.shape).astype(np.float32)
        out[k] = _randomize(v, rng)
    return out


def jax_probe_tree(name, seed=0):
    """A probe's cut tree as numpy in the JAX layout, trivial leaves randomised."""
    tree = cut(name, bridge.probe_init(name, "cpu"))
    return _randomize(bridge.to_numpy_tree(tree), np.random.default_rng(seed))


def _jax_init_shapes(name):
    """Flattened keys and shapes of the JAX package's own init of a probe."""
    if name in SEG:
        init = JDL.deeplabv3plus_init if name == "dlv3pr50" else JRFN.refinenet_lw_init
        tree = jax.eval_shape(init, jax.random.PRNGKey(0))
    else:
        base = name[:-3] if name.endswith("_ft") else name
        init, _, _, n = JCZ._SPECS[base]
        tree = jax.eval_shape(lambda k: init(k, n), jax.random.PRNGKey(0))
    return {k: tuple(v.shape) for k, v in JCK.tree_flatten_dict(tree).items()}


def calibrate_bn(name, tree, apply, x):
    """``tree`` (numpy, JAX layout) with every BatchNorm's running mean and
    variance set to those of its input in one pass of the port's ``apply`` on
    ``x`` (per channel over batch and space; a BatchNorm that sees one value a
    channel keeps its own). The seeded convolutions shrink the signal about
    threefold a layer (kaiming-uniform, a = sqrt(5)), so that with unit
    statistics a deep net's logits are its head's bias alone."""
    port = bridge.probes_from_jax({name: tree}, device="cpu", cut=cut)[name]
    norm = TRN.batch_norm

    def calibrating(p, h, eps=1e-5):
        if h[..., 0].numel() > 1:  # not the 1 x 1 pooled branch: one value, no variance
            p["mean"].copy_(h.mean(dim=(0, 1, 2)))
            p["var"].copy_(h.var(dim=(0, 1, 2), unbiased=False))
        return norm(p, h, eps)

    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(TRN, "batch_norm", calibrating)
        apply(port, torch.from_numpy(x))
    return bridge.to_numpy_tree(port)


@pytest.mark.parametrize("name", PROBES)
def test_probe_matches_jax(name):
    japply, tapply, shape = _apply_pair(name)
    x = np.random.default_rng(1).uniform(size=shape).astype(np.float32)
    ref = calibrate_bn(name, jax_probe_tree(name), tapply, x)
    port = bridge.probes_from_jax({name: ref}, device="cpu", cut=cut)[name]
    want = np.asarray(jax.jit(japply)(jax.tree.map(jnp.asarray, ref), jnp.asarray(x)))
    with torch.inference_mode():
        got = tapply(port, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    if name in SEG:
        assert want.shape == (*shape[:3], 19)
    else:
        assert want.shape == (shape[0], TCZ._SPECS[name][3])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("name", PROBES)
def test_probe_tree_has_the_jax_keys_and_shapes(name):
    port = {}
    for k, v in bridge.flatten(bridge.probe_init(name, "meta")).items():
        s = tuple(v.shape)
        port[k] = (s[2], s[3], s[1], s[0]) if k.split("//")[-1] == "w" and len(s) == 4 else s
    assert port == _jax_init_shapes(name)


def test_swin_tables_and_mask_equal_jax():
    for got, want in ((TSW._relative_position_index(7), JSW._relative_position_index(7)),
                      (TSW._cpb_coords_table(8), JSW._cpb_coords_table(8)),
                      (TSW._shift_mask(16, 16, 8, 4), JSW._shift_mask(16, 16, 8, 4))):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,size", [((1, 5, 7, 3), (11, 13)), ((2, 16, 24, 5), (32, 48)),
                                        ((1, 33, 17, 4), (12, 9)), ((1, 40, 30, 2), (21, 64))],
                         ids=["up_odd", "up_even", "down_odd", "mixed"])
def test_resize_bilinear_ac_matches_jax(shape, size):
    x = np.random.default_rng(3).uniform(size=shape).astype(np.float32)
    want = np.asarray(JR.resize_bilinear_ac(jnp.asarray(x), size))
    got = TR.resize_bilinear_ac(torch.from_numpy(x), size).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["all", "all_ft", "single", "bare", "CUB", "nope"])
def test_classifier_sets_match_jax(mode):
    if mode == "nope":
        for mod in (TCZ, JCZ):
            with pytest.raises(ValueError, match="Unknown eval_mode: nope"):
                mod.model_types_for(mode)
        return
    assert TCZ.model_types_for(mode) == JCZ.model_types_for(mode)


@pytest.mark.parametrize("mode", ["single", "all", "bare", "nope"])
def test_seg_sets_match_jax(mode):
    if mode == "nope":
        for mod in (TSZ, JSZ):
            with pytest.raises(ValueError, match="Unknown eval_mode: nope"):
                mod.model_types_for(mode)
        return
    assert TSZ.model_types_for(mode) == JSZ.model_types_for(mode)
    assert TSZ._WEIGHTS == JSZ._WEIGHTS


def test_zoo_names_and_weights_follow_jax():
    assert TCZ._SPECS.keys() == JCZ._SPECS.keys()
    for name, spec in JCZ._SPECS.items():
        assert TCZ._SPECS[name][2:] == spec[2:], name
    assert TCZ._spec("vgg_ft")[2] == "vgg16_ft" and TCZ._spec("cub_swin")[3] == 200
    for bad in ("resnet50", "cub_vgg", "vit_ft_ft"):
        with pytest.raises(ValueError, match=f"Unknown classifier name: {bad}"):
            TCZ.build_classifier(bad, device="cpu")
        with pytest.raises(ValueError, match=f"Unknown classifier name: {bad}"):
            JCZ.build_classifier(bad, jit=False)
    for bad in ("dlv3pr101", "rflwr50"):
        with pytest.raises(ValueError, match=f"Unknown model type: {bad}"):
            TSZ.build_seg_probe(bad, device="cpu")
        with pytest.raises(ValueError, match=f"Unknown model type: {bad}"):
            JSZ.build_seg_probe(bad, jit=False)


def test_npz_from_a_jax_tree_loads_whole(tmp_path):
    """A converter's .npz (the JAX tree, flat) loads through ``zoo.load_npz_tree``
    with no key missing and none left over, and the probe built on it gives the
    logits of the loaded tree."""
    tree = _randomize(bridge.to_numpy_tree(bridge.probe_init("cub_r18", "cpu")),
                      np.random.default_rng(4))
    flat = JCK.tree_flatten_dict(tree)
    np.savez(tmp_path / "cub_resnet18.npz", **flat)
    template = TCZ.classifier_init("cub_r18", device="cpu")
    loaded, ok = zoo.load_npz_tree("cub_resnet18", template, tmp_path)
    assert ok
    assert bridge.flatten(loaded).keys() == flat.keys()
    for k, v in bridge.flatten(bridge.to_numpy_tree(loaded)).items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)
    x = np.random.default_rng(5).uniform(size=(1, 40, 40, 3)).astype(np.float32)
    probe = TCZ.build_classifier("cub_r18", device="cpu", weights_dir=tmp_path)
    want = np.asarray(JRN.resnet_apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x)))
    got = probe(x)
    assert got.dtype == np.float32 and got.shape == (1, 200)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(np.abs(want).max()))
