"""Port parity: transformer, Controller, SC-Tuner and the controlled UNet.

Tiny configs with every leaf re-randomised: the Controller's zero convs and
zero out-projections, which make its maps pure biases at init, carry real
weights here. fp32 on the CPU. Tolerances: 2e-5 for single blocks; 1e-4 for
the Controller and UNet stacks, whose dozens of convs, norms and matmuls sum
in a different order on XLA:CPU and oneDNN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bridge import META, jax_params, nhwc, port_params, randomize, to_np
from unirestore_torch import bridge
from unirestore_torch.models import controller as TCT
from unirestore_torch.models import scedit as TSC
from unirestore_torch.models import unet as TUN
from unirestore_torch.nn import transformer as TTR
from unirestore_tpu.models import controller as JCT
from unirestore_tpu.models import scedit as JSC
from unirestore_tpu.models import unet as JUN
from unirestore_tpu.nn import transformer as JTR

torch.set_num_threads(2)
BLOCK_TOL = dict(atol=2e-5, rtol=2e-5)
STACK_TOL = dict(atol=1e-4, rtol=1e-4)


def close(port, ref, tol=BLOCK_TOL):
    np.testing.assert_allclose(to_np(port), np.asarray(ref), **tol)


def test_transformer_2d():
    pj = jax_params(JTR.transformer_2d_init, 64, 2, 48)
    pt = port_params(pj, TTR.transformer_2d_init, 64, 2, 48)
    x, ctx = nhwc(0, 2, 8, 8, 64), nhwc(1, 2, 77, 48)
    ref = JTR.transformer_2d(pj, jnp.asarray(x), jnp.asarray(ctx), heads=2, groups=8)
    out = TTR.transformer_2d(pt, torch.from_numpy(x), torch.from_numpy(ctx), heads=2, groups=8)
    close(out, ref)


def test_csce_adapter():
    pj = jax_params(JSC.csce_adapter_init, 32, 32, 16)
    pt = port_params(pj, TSC.csce_adapter_init, 32, 32, 16)
    x, c = nhwc(2, 2, 8, 8, 32), nhwc(3, 2, 8, 8, 16)
    close(TSC.csce_adapter(pt, *map(torch.from_numpy, (x, c))),
          JSC.csce_adapter(pj, *map(jnp.asarray, (x, c))))


def test_controller_apply_all_four_maps():
    cj, ct = JCT.tiny_controller_config(), TCT.tiny_controller_config()
    pj = jax_params(JCT.controller_init, cj)
    pt = port_params(pj, TCT.controller_init, ct)
    x, t = nhwc(4, 2, 16, 16, 4), np.array([999, 499], np.int32)
    ref = jax.jit(lambda p, x, t: JCT.controller_apply(p, cj, x, t))(pj, x, t)
    out = TCT.controller_apply(pt, ct, torch.from_numpy(x), torch.from_numpy(t))
    assert len(out) == len(ref) == 4
    for a, b in zip(out, ref):
        close(a, b, STACK_TOL)


def _unet_setup(seed=0):
    cj, ct = JUN.tiny_unet_config(), TUN.tiny_unet_config()
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    pj = randomize({"unet": JUN.unet_init(k1, cj),
                    "control": JUN.control_adapters_init(k2, cj)}, seed + 1)
    template = {"unet": TUN.unet_init(META, ct), "control": TUN.control_adapters_init(META, ct)}
    pt = bridge.load_tree(pj, template, device="cpu")
    rng = np.random.default_rng(seed + 2)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([999, 249], np.int32)
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    control = [rng.standard_normal((2, 16 >> i, 16 >> i, 32)).astype(np.float32)
               for i in range(4)]
    return cj, ct, pj, pt, (x, t, ctx, control)


def _t(a):
    return [torch.from_numpy(x) for x in a] if isinstance(a, list) else torch.from_numpy(a)


def test_unet_apply():
    cj, ct, pj, pt, (x, t, ctx, control) = _unet_setup()
    ref = jax.jit(lambda p, *a: JUN.unet_apply(p["unet"], cj, *a, control_params=p["control"]))(
        pj, x, t, ctx, control)
    out = TUN.unet_apply(pt["unet"], ct, _t(x), _t(t), _t(ctx), _t(control),
                         control_params=pt["control"])
    close(out, ref, STACK_TOL)


@pytest.mark.parametrize("part", ["encode_decode_deep", "shallow"])
def test_unet_split_paths(part):
    cj, ct, pj, pt, (x, t, ctx, control) = _unet_setup(seed=5)

    def jax_side(p, x, t, ctx, control):
        up, cp = p["unet"], p["control"]
        emb = JUN.unet_time_embedding(up, cj, t, x.dtype)
        h, skips = JUN.unet_encode(up, cj, x, emb, ctx, control, cp)
        eps, deep = JUN.unet_decode(up, cj, h, skips, emb, ctx, control, cp, return_deep=True)
        if part == "encode_decode_deep":
            return eps, deep
        s0 = JUN.unet_down_shallow(up, cj, x, emb, ctx, control, cp)
        return s0, JUN.unet_up_shallow(up, cj, deep, s0, emb, ctx, control, cp)

    up, cp = pt["unet"], pt["control"]
    xt, ctxt, ctrl = _t(x), _t(ctx), _t(control)
    emb = TUN.unet_time_embedding(up, ct, _t(t), xt.dtype)
    h, skips = TUN.unet_encode(up, ct, xt, emb, ctxt, ctrl, cp)
    eps, deep = TUN.unet_decode(up, ct, h, skips, emb, ctxt, ctrl, cp, return_deep=True)
    ref = jax.jit(jax_side)(pj, x, t, ctx, control)
    if part == "encode_decode_deep":
        close(eps, ref[0], STACK_TOL)
        close(deep, ref[1], STACK_TOL)
    else:
        s0 = TUN.unet_down_shallow(up, ct, xt, emb, ctxt, ctrl, cp)
        assert len(s0) == len(ref[0]) == 3
        for a, b in zip(s0, ref[0]):
            close(a, b, STACK_TOL)
        close(TUN.unet_up_shallow(up, ct, deep, s0, emb, ctxt, ctrl, cp), ref[1], STACK_TOL)
