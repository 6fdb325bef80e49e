"""Port parity: one stage-1 loss and its gradients under ``control_type="spade"``.

``train/steps.py:compute_losses`` of the port (remat on, as the train step
runs it) against the JAX ``compute_losses`` under ``jax.value_and_grad``, on
the tiny SPADE config's seeded init with every all-zero leaf filled
(``tests/test_torch_eval.py:filled_init``) and the JAX function's own noise
draws (``tests/test_torch_train.py:_jax_noise``), one 128 px pair. Tolerances
as ``tests/test_torch_train.py``: losses 1e-5 relative, gradients 1e-4 of the
largest of the leaf's family. SPADE puts trainable leaves in every resnet of
the UNet, so the down path and the mid block carry gradients, which under
``scedit`` they do not.
"""

import jax
import jax.numpy as jnp
import torch

from test_torch_eval import filled_init
from test_torch_train import _assert_losses_and_grads_match, _batch, _jax_noise, _port_grads
from unirestore_torch import bridge
from unirestore_torch.models import unirestore as TUR
from unirestore_torch.train import steps as TS
from unirestore_tpu.models import unirestore as JUR
from unirestore_tpu.train import steps as JS

torch.set_num_threads(2)
STAGE1 = dict(train_cfrm=True, train_cnet=True, train_tfa=False)


def test_spade_stage1_losses_and_grads_match_jax():
    cj = JUR.tiny_config(use_tfa=False, control_type="spade", tasks=("ir",))
    ct = TUR.tiny_config(use_tfa=False, control_type="spade", tasks=("ir",))
    ft, tt = filled_init(ct, seed=31)
    fj, tj = (jax.tree.map(jnp.asarray, bridge.to_numpy_tree(t)) for t in (ft, tt))
    batch, rng = _batch(32, b=1, hw=128), jax.random.PRNGKey(33)
    sched = JUR.schedule(cj)
    fn = jax.jit(jax.value_and_grad(
        lambda tr, b, r: JS.compute_losses(fj, tr, cj, sched, JS.StageConfig(**STAGE1),
                                           b, r, "ir"), has_aux=True))
    (loss_j, logs_j), grads_j = fn(tj, batch, rng)
    loss, logs, grads = _port_grads(ft, tt, TS.with_remat(ct), TS.StageConfig(**STAGE1),
                                    batch, _jax_noise(cj, batch, rng), "ir")
    _assert_losses_and_grads_match(STAGE1, "ir", tt, loss, logs, grads, loss_j, logs_j,
                                   grads_j)
    for part in ("down//0//0", "mid//1", "up//3//2"):
        sp = [g for k, g in grads.items() if k.startswith(f"control//spades//{part}//")]
        assert sp and all(float(g.abs().max()) > 0 for g in sp), part
