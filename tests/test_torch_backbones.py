"""Port parity: DeepLab's other backbones (``unirestore_torch/tasks/backbones.py``)
and every name of ``deeplab_factory``, against ``unirestore_tpu/tasks/``.

One set of weights on both sides: the port's seeded tree at published widths
and full depth, BatchNorm affines and statistics randomised, then every
BatchNorm's statistics set from its input over one seeded 64 x 64 image
(``calibrate``: with a seeded init's unit statistics kaiming-uniform
convolutions shrink the signal about threefold a layer, and a deep net's
output is its head's bias), handed to the JAX functions in the JAX layout.
The HRNets are in ``tests/test_torch_backbones_hrnet.py``.
The JAX functions run eagerly (an XLA compile of Xception or HRNet-48 costs
more than the comparison). fp32 on the CPU. Tolerances: the backbone's
features and the logits within 1e-4 of their largest |value| (fp32
convolutions summed in another order through up to 60 layers), the trees'
keys and shapes equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bridge import META
from test_torch_probes import _randomize
from unirestore_torch import bridge
from unirestore_torch.nn.init import make_init
from unirestore_torch.tasks import deeplab as TDL
from unirestore_torch.tasks import resnet as TRN
from unirestore_tpu.tasks import deeplab as JDL
from unirestore_tpu.train import checkpoints as JCK

torch.set_num_threads(2)
FACTORY = {"mobilenet": "mobilenetv2", "xception": "xception", "hrnetv2_32": "hrnetv2_32",
           "hrnetv2_48": "hrnetv2_48", "resnet50": "resnet50", "resnet101": "resnet101"}
NAMES = tuple(f"deeplabv3{plus}_{b}" for b in FACTORY for plus in ("", "plus"))
RTOL = 1e-4


def _shapes(tree):
    out = {}
    for k, v in bridge.flatten(tree).items():
        s = tuple(v.shape)
        out[k] = (s[2], s[3], s[1], s[0]) if k.split("//")[-1] == "w" and len(s) == 4 else s
    return out


@pytest.mark.parametrize("name", NAMES)
def test_factory_tree_has_the_jax_keys_and_shapes(name):
    init_t, _ = TDL.deeplab_factory(name)
    init_j, _ = JDL.deeplab_factory(name)
    want = jax.eval_shape(init_j, jax.random.PRNGKey(0))
    assert _shapes(init_t(META)) == {k: tuple(v.shape) for k, v in
                                     JCK.tree_flatten_dict(want).items() if v is not None}
    c_high, c_low = TDL.BACKBONE_CHANNELS[FACTORY[name.split("_", 1)[1]]]
    assert (c_high, c_low) == JDL.BACKBONE_CHANNELS[FACTORY[name.split("_", 1)[1]]]


def calibrate(tree, apply, x):
    """``tree`` with every BatchNorm's running mean set to its input's
    per-channel mean, and its variance to the mean over channels of its
    input's variance, in one pass of ``apply`` on ``x`` (a BatchNorm that sees
    one value a channel, the ASPP pooling branch, keeps its own). Per-channel
    variances would blow a nearly constant channel up to unit scale: at full
    depth that makes the port's own fp32 output 0.4 % (Xception) to 3 % (HRNet)
    from its fp64 output; the layer's mean variance keeps it within 6e-5."""
    norm = TRN.batch_norm

    def calibrating(p, h, eps=1e-5):
        if h[..., 0].numel() > 1:
            p["mean"].copy_(h.mean(dim=(0, 1, 2)))
            p["var"].fill_(h.var(dim=(0, 1, 2), unbiased=False).mean())
        return norm(p, h, eps)

    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(TRN, "batch_norm", calibrating)
        apply(tree, x)
    return tree


def _pair(name, seed):
    """(port tree, JAX tree) of one factory name with calibrated statistics, the input."""
    init_t, apply_t = TDL.deeplab_factory(name)
    seeded = init_t(make_init(device="cpu", seed=seed))
    tree = _randomize(bridge.to_numpy_tree(seeded), np.random.default_rng(seed + 1))
    port = bridge.load_tree(tree, init_t(META), device="cpu")
    x = np.random.default_rng(seed + 2).uniform(size=(1, 64, 64, 3)).astype(np.float32)
    port = calibrate(port, apply_t, torch.from_numpy(x))
    return port, jax.tree.map(jnp.asarray, bridge.to_numpy_tree(port)), x


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RTOL * float(np.abs(want).max()))


def check_features_and_logits(backbone, plus):
    """The backbone's {"low", "high"} (deeplabv3plus only: the same features
    feed both heads) and the logits of the factory's apply."""
    name = f"deeplabv3{plus}_{backbone}"
    port, ref, x = _pair(name, seed=len(name))
    _, apply_t = TDL.deeplab_factory(name)
    _, apply_j = JDL.deeplab_factory(name)
    with torch.inference_mode():
        got = apply_t(port, torch.from_numpy(x))
        if plus:
            bb, xn = FACTORY[backbone], TRN.normalize(torch.from_numpy(x))
            feats = TDL._backbone_features(port["backbone"], bb, xn, 16)
    if plus:
        want = JDL._backbone_features(ref["backbone"], bb, jnp.asarray(xn.numpy()), 16)
        for k in ("low", "high"):
            _close(feats[k], want[k])
        c_high, c_low = TDL.BACKBONE_CHANNELS[bb]
        assert feats["high"].shape[-1] == c_high and feats["low"].shape[-1] == c_low
        assert feats["low"].shape[1] == 16  # /4
        assert feats["high"].shape[1] == (16 if bb.startswith("hrnet") else 4)
    want = apply_j(ref, jnp.asarray(x))
    assert got.shape == (1, 64, 64, 19)
    _close(got, want)


@pytest.mark.parametrize("plus", ["", "plus"])
@pytest.mark.parametrize("backbone", ["mobilenet", "xception"])
def test_features_and_logits_match_jax(backbone, plus):
    check_features_and_logits(backbone, plus)


class _Stop(Exception):
    pass


def test_hrnet_runs_at_output_stride_4(monkeypatch):
    """JAX ``deeplab_factory``'s HRNet rule (``unirestore_tpu/tasks/deeplab.py:
    137-138``): the factory's apply hands the backbone output stride 4,
    whatever it was asked for; the other backbones keep the one asked for."""
    seen = {}
    for mod, key in ((TDL, "port"), (JDL, "jax")):
        def recording(p, backbone, x, output_stride, key=key):
            seen.setdefault(key, []).append(output_stride)
            raise _Stop

        monkeypatch.setattr(mod, "_backbone_features", recording)
    x = np.zeros((1, 32, 32, 3), np.float32)
    for name in ("deeplabv3plus_hrnetv2_48", "deeplabv3_mobilenet"):
        for mod, xin in ((TDL, torch.from_numpy(x)), (JDL, jnp.asarray(x))):
            _, apply_fn = mod.deeplab_factory(name, output_stride=16)
            with pytest.raises(_Stop):
                apply_fn({"backbone": None}, xin)
    assert seen == {"port": [4, 16], "jax": [4, 16]}
