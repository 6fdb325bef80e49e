"""Port parity: ResNet/NAF/CFRM/TFA blocks and the VAE with CFRM and TFA.

Tiny configs, every param leaf re-randomised (NAF beta/gamma and TFA prompts
start at zero, which would make whole branches identities), fp32 on the CPU.
Tolerance 1e-4 for the composed VAE (tens of convs and norms; fp32 rounding
differences of XLA:CPU vs oneDNN summation order grow through the stack)
and 2e-5 for single blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bridge import META, jax_params, nhwc, port_params, randomize, to_np
from unirestore_torch import bridge
from unirestore_torch.models import cfrm as TC
from unirestore_torch.models import nafnet as TN
from unirestore_torch.models import tfa as TT
from unirestore_torch.models import vae as TV
from unirestore_torch.nn import resnet as TR
from unirestore_tpu.models import cfrm as JC
from unirestore_tpu.models import nafnet as JN
from unirestore_tpu.models import tfa as JT
from unirestore_tpu.models import vae as JV
from unirestore_tpu.nn import resnet as JR

torch.set_num_threads(2)
BLOCK_TOL = dict(atol=2e-5, rtol=2e-5)
VAE_TOL = dict(atol=1e-4, rtol=1e-4)


def close(port, ref, tol=BLOCK_TOL):
    np.testing.assert_allclose(to_np(port), np.asarray(ref), **tol)


@pytest.mark.parametrize("cin,cout,temb", [(32, 32, None), (32, 64, 48)])
def test_resnet_block(cin, cout, temb):
    pj = jax_params(JR.resnet_block_init, cin, cout, temb)
    pt = port_params(pj, TR.resnet_block_init, cin, cout, temb)
    x = nhwc(0, 2, 8, 8, cin)
    e = nhwc(1, 2, 48) if temb else None
    ref = JR.resnet_block(pj, jnp.asarray(x), None if e is None else jnp.asarray(e), groups=8)
    out = TR.resnet_block(pt, torch.from_numpy(x), None if e is None else torch.from_numpy(e),
                          groups=8)
    close(out, ref)


def test_naf_block():
    pj = jax_params(JN.naf_block_init, 16)
    pt = port_params(pj, TN.naf_block_init, 16)
    x = nhwc(2, 2, 8, 8, 16)
    close(TN.naf_block(pt, torch.from_numpy(x)), JN.naf_block(pj, jnp.asarray(x)))


def test_ada_naf_v2():
    pj = jax_params(JC.ada_naf_v2_init, 16)
    pt = port_params(pj, TC.ada_naf_v2_init, 16)
    x = nhwc(3, 2, 8, 8, 16)
    close(TC.ada_naf_v2(pt, torch.from_numpy(x)), JC.ada_naf_v2(pj, jnp.asarray(x)))


def test_cfrm_stage():
    pj = jax_params(JC.cfrm_stage_init, 16, 2)
    pt = port_params(pj, TC.cfrm_stage_init, 16, 2)
    x = nhwc(4, 2, 8, 8, 16)
    close(TC.cfrm_stage(pt, torch.from_numpy(x)), JC.cfrm_stage(pj, jnp.asarray(x)))


@pytest.mark.parametrize("last", [False, True])
def test_task_feature_adapter(last):
    pj = jax_params(JT.task_feature_adapter_init, 32, 16, 1, last)
    pt = port_params(pj, TT.task_feature_adapter_init, 32, 16, 1, last)
    x, skip, cond = nhwc(5, 2, 8, 8, 32), nhwc(6, 2, 8, 8, 16), nhwc(7, 2, 1, 16)
    xj, cj = JT.task_feature_adapter(pj, *map(jnp.asarray, (x, skip, cond)))
    xt, ct = TT.task_feature_adapter(pt, *map(torch.from_numpy, (x, skip, cond)))
    close(xt, xj)
    assert (ct is None) == (cj is None) == last
    if not last:
        close(ct, cj)


def _vae_pair(seed=0):
    cj, ct = JV.tiny_vae_config(), TV.tiny_vae_config()
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    pj = randomize({"vae": JV.vae_init(k1, cj), "cfrm": JV.cfrm_adapter_init(k2, cj),
                    "tfa": JV.tfa_adapter_init(k3, cj, ("ir", "seg"))}, seed + 1)
    template = {"vae": TV.vae_init(META, ct), "cfrm": TV.cfrm_adapter_init(META, ct),
                "tfa": TV.tfa_adapter_init(META, ct, ("ir", "seg"))}
    return cj, ct, pj, bridge.load_tree(pj, template, device="cpu")


@pytest.mark.parametrize("enable_fr", [True, False])
def test_encode_moments(enable_fr):
    cj, ct, pj, pt = _vae_pair()
    x = np.random.default_rng(8).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    mj, lj, sj = jax.jit(lambda p, x: JV.encode_moments(p["vae"], x, cj, p["cfrm"],
                                                        enable_fr))(pj, x)
    mt, lt, st = TV.encode_moments(pt["vae"], torch.from_numpy(x), ct, pt["cfrm"], enable_fr)
    close(mt, mj, VAE_TOL)
    close(lt, lj, VAE_TOL)
    assert len(st) == len(sj) == 3
    for a, b in zip(st, sj):
        close(a, b, VAE_TOL)


@pytest.mark.parametrize("task", ["seg", None])
def test_decode_with_task(task):
    cj, ct, pj, pt = _vae_pair(seed=3)
    z = nhwc(9, 2, 4, 4, 4)
    skips = [nhwc(10 + i, 2, 16 >> i, 16 >> i, c) for i, c in enumerate(cj.skip_channels)]
    ref = jax.jit(lambda p, z, s: JV.decode(p["vae"], z, cj, s, p["tfa"], task))(pj, z, skips)
    out = TV.decode(pt["vae"], torch.from_numpy(z), ct, [torch.from_numpy(s) for s in skips],
                    pt["tfa"], task)
    close(out, ref, VAE_TOL)
