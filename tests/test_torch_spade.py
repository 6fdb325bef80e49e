"""Port parity: the ``spade`` control type and the model leftovers.

``models/spade.py``, the UNet under SPADE (``_resnet_maybe_spade`` at its five
call sites), the trees of the ``tiny`` route and of
``train/engine.py:build_model_config`` under ``spade`` against the JAX
package's, ``nafnet``, ``sce_adapter`` and the ``encoder_propagation`` alias.
The restore in the three cache modes is in ``tests/test_torch_spade_restore.py``
and the stage-1 step in ``tests/test_torch_spade_train.py``. fp32 on the CPU,
tiny configs, every leaf re-randomised (so the zero-initialised NAF gates and
zero convs carry weights). Tolerances, as the other port
tests hold the same kinds of function:

- ``spade``, ``nafnet``, ``sce_adapter``: 1e-5;
- ``unet_apply`` and the deep cache mode's level-0 pair: 1e-4 (dozens of
  convs and norms summed in another order on XLA:CPU and oneDNN);
- the ``encoder_propagation`` alias: bit-equal to ``cache_mode="encoder"``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bridge import META, jax_params, nhwc, port_params, to_np
from test_torch_denoiser import STACK_TOL, _t
from unirestore_torch import bridge
from unirestore_torch.models import nafnet as TNF
from unirestore_torch.models import scedit as TSC
from unirestore_torch.models import spade as TSP
from unirestore_torch.models import unet as TUN
from unirestore_torch.models import unirestore as TUR
from unirestore_torch.train import engine as TE
from unirestore_tpu.models import nafnet as JNF
from unirestore_tpu.models import scedit as JSC
from unirestore_tpu.models import spade as JSP
from unirestore_tpu.models import unet as JUN
from unirestore_tpu.models import unirestore as JUR
from unirestore_tpu.train import checkpoints as JCK
from unirestore_tpu.train import engine as JE

torch.set_num_threads(2)
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
SPADE_PARAMS_SD_TURBO = 53_020_160  # 22 x 295,040 + 2 x 1,153 x 20,160 + 40,320


def close(port, ref, tol=LAYER_TOL):
    np.testing.assert_allclose(to_np(port), np.asarray(ref), **tol)


@pytest.mark.parametrize("x_hw,seg_hw", [((16, 16), (4, 4)), ((8, 12), (3, 5))],
                         ids=["upsample", "ragged"])
def test_spade_resizes_control(x_hw, seg_hw):
    """``tests/test_models.py::test_spade_resizes_control``, and the values."""
    pj = jax_params(JSP.spade_init, 64, 32)
    pt = port_params(pj, TSP.spade_init, 64, 32)
    x, seg = nhwc(1, 2, *x_hw, 64), nhwc(2, 2, *seg_hw, 32)
    out = TSP.spade(pt, torch.from_numpy(x), torch.from_numpy(seg))
    assert out.shape == x.shape
    close(out, JSP.spade(pj, jnp.asarray(x), jnp.asarray(seg)))


def _spade_unet(seed):
    cj, ct = JUN.tiny_unet_config("spade"), TUN.tiny_unet_config("spade")
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    pj = jax_params(lambda k: {"unet": JUN.unet_init(k1, cj),
                               "control": JUN.control_adapters_init(k2, cj)}, seed=seed)
    template = {"unet": TUN.unet_init(META, ct), "control": TUN.control_adapters_init(META, ct)}
    pt = bridge.load_tree(pj, template, device="cpu")
    rng = np.random.default_rng(seed + 2)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([999, 249], np.int32)
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    control = [rng.standard_normal((2, 16 >> i, 16 >> i, 32)).astype(np.float32)
               for i in range(4)]
    return cj, ct, pj, pt, (x, t, ctx, control)


@pytest.mark.parametrize("part", ["apply", "shallow"])
def test_unet_under_spade_matches_jax(part):
    """``unet_apply`` (the ``[spade]`` case of ``tests/test_models.py::
    test_unet_controlled_forward``), and the deep cache mode's level-0 pair
    ``unet_down_shallow`` / ``unet_up_shallow``; remat on in the port changes
    nothing in a forward pass."""
    cj, ct, pj, pt, (x, t, ctx, control) = _spade_unet(seed=3)
    assert len(pt["control"]["spades"]["mid"]) == 2
    up, cp = pt["unet"], pt["control"]
    if part == "apply":
        ref = jax.jit(lambda p, *a: JUN.unet_apply(p["unet"], cj, *a,
                                                   control_params=p["control"]))(
            pj, x, t, ctx, control)
        for c in (ct, dataclasses.replace(ct, remat=True)):
            out = TUN.unet_apply(up, c, _t(x), _t(t), _t(ctx), _t(control), control_params=cp)
            assert out.shape == x.shape
            close(out, ref, STACK_TOL)
        return

    def jax_side(p, x, t, ctx, control):
        emb = JUN.unet_time_embedding(p["unet"], cj, t, x.dtype)
        h, skips = JUN.unet_encode(p["unet"], cj, x, emb, ctx, control, p["control"])
        _, deep = JUN.unet_decode(p["unet"], cj, h, skips, emb, ctx, control, p["control"],
                                  return_deep=True)
        s0 = JUN.unet_down_shallow(p["unet"], cj, x, emb, ctx, control, p["control"])
        return s0, JUN.unet_up_shallow(p["unet"], cj, deep, s0, emb, ctx, control,
                                       p["control"])

    ref_s0, ref_eps = jax.jit(jax_side)(pj, x, t, ctx, control)
    xt, ctxt, ctrl = _t(x), _t(ctx), _t(control)
    emb = TUN.unet_time_embedding(up, ct, _t(t), xt.dtype)
    h, skips = TUN.unet_encode(up, ct, xt, emb, ctxt, ctrl, cp)
    _, deep = TUN.unet_decode(up, ct, h, skips, emb, ctxt, ctrl, cp, return_deep=True)
    s0 = TUN.unet_down_shallow(up, ct, xt, emb, ctxt, ctrl, cp)
    for a, b in zip(s0, ref_s0, strict=True):
        close(a, b, STACK_TOL)
    close(TUN.unet_up_shallow(up, ct, deep, s0, emb, ctxt, ctrl, cp), ref_eps, STACK_TOL)


def test_nafnet_matches_jax():
    args = dict(img_channels=3, width=8, middle_blk_num=1, enc_blk_nums=(1,),
                dec_blk_nums=(1,))
    pj = jax_params(lambda k: JNF.nafnet_init(k, **args))
    pt = port_params(pj, lambda ini: TNF.nafnet_init(ini, **args))
    x = nhwc(4, 2, 16, 24, 3)
    out = TNF.nafnet(pt, torch.from_numpy(x))
    assert out.shape == x.shape
    close(out, jax.jit(JNF.nafnet)(pj, jnp.asarray(x)))


def test_sce_adapter_matches_jax():
    pj = jax_params(JSC.sce_adapter_init, 32, 48)
    pt = port_params(pj, TSC.sce_adapter_init, 32, 48)
    x = nhwc(5, 2, 8, 8, 32)
    close(TSC.sce_adapter(pt, torch.from_numpy(x)), JSC.sce_adapter(pj, jnp.asarray(x)))


def test_encoder_propagation_is_the_encoder_cache_mode():
    """The config field and the keyword, with JAX's precedence: the field
    applies only when no ``cache_mode`` is passed and ``cfg.cache_mode`` is
    "none"."""
    cfg = dataclasses.replace(TUR.tiny_config(), cache_stride=2)
    frozen, trainable = TUR.init(cfg, device="cpu", seed=3)
    gen = torch.Generator().manual_seed(4)
    zt, z0 = (torch.randn((1, 8, 8, 4), generator=gen) for _ in range(2))
    sched = TUR.schedule(cfg)

    def run(c, **kw):
        with torch.inference_mode():
            return TUR.ddim_denoise(frozen, trainable, c, sched, zt, z0, 4, **kw)

    encoder, exact, deep = (run(cfg, cache_mode=m) for m in ("encoder", "none", "deep"))
    assert not torch.equal(encoder, exact)
    alias = dataclasses.replace(cfg, encoder_propagation=True)
    assert torch.equal(run(cfg, encoder_propagation=True), encoder)
    assert torch.equal(run(cfg, encoder_propagation=True, cache_mode="deep"), encoder)
    assert torch.equal(run(alias), encoder)
    assert torch.equal(run(alias, cache_mode="none"), exact)
    assert torch.equal(run(dataclasses.replace(alias, cache_mode="deep")), deep)


def _shapes(tree, conv_hwio):
    """{flat key: shape}, 4-D conv kernels given in HWIO when ``conv_hwio``."""
    out = {}
    for k, v in bridge.flatten(tree).items():
        s = tuple(v.shape)
        if conv_hwio and k.split("//")[-1] == "w" and len(s) == 4:
            s = (s[2], s[3], s[1], s[0])
        out[k] = s
    return out


def _jax_shapes(cfg):
    frozen, trainable = jax.eval_shape(lambda k: JUR.init(k, cfg), jax.random.PRNGKey(0))
    return tuple({k: tuple(v.shape) for k, v in JCK.tree_flatten_dict(t).items()}
                 for t in (frozen, trainable))


@pytest.mark.parametrize("route", ["tiny", "build_model_config"])
def test_spade_trees_have_the_jax_keys_and_shapes(route):
    """Repair of ``use_cnet``: under ``spade`` the port builds the UNet, the
    Controller and the control adapters. Full width from the CLI's
    ``build_model_config`` keeps ``unet=UNetConfig()`` (SC-Tuner editors, as
    the JAX function builds); the ``tiny`` route builds real SPADE."""
    kwargs = {"frenc": {"type": "CFRM", "train": True},
              "cnet": {"type": "spade", "train": True}}
    cj, _ = JE.build_model_config(kwargs)
    ct, stage = TE.build_model_config(kwargs)
    assert ct.use_cnet and cj.use_cnet and stage.train_cnet
    if route == "tiny":
        cj = JUR.tiny_config(use_tfa=cj.use_tfa, control_type=cj.control_type, tasks=cj.tasks)
        ct = TUR.tiny_config(use_tfa=ct.use_tfa, control_type=ct.control_type, tasks=ct.tasks)
    frozen, trainable = TUR.init(ct, device="meta")
    assert sorted(frozen) == ["null_emb", "unet", "vae"]
    assert sorted(trainable) == ["cfrm", "control", "controller"]
    assert list(trainable["control"]) == (["spades"] if route == "tiny" else ["csc_editors"])
    want_f, want_t = _jax_shapes(cj)
    assert _shapes(frozen, True) == want_f
    assert _shapes(trainable, True) == want_t


def test_spade_adapters_at_sd_turbo_widths_count_as_jax():
    cfg_t = TUN.UNetConfig(control_type="spade")
    cfg_j = JUN.UNetConfig(control_type="spade")
    port = TUN.control_adapters_init(META, cfg_t)
    want = jax.eval_shape(lambda k: JUN.control_adapters_init(k, cfg_j), jax.random.PRNGKey(0))
    assert [len(port["spades"][k]) for k in ("down", "mid", "up")] == [4, 2, 4]
    assert sum(map(len, port["spades"]["down"] + port["spades"]["up"])) + 2 == 22
    n_port = sum(v.numel() for v in bridge.flatten(port).values())
    n_jax = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(want))
    assert n_port == n_jax == SPADE_PARAMS_SD_TURBO
    assert _shapes(port, True) == {k: tuple(v.shape)
                                   for k, v in JCK.tree_flatten_dict(want).items()}
