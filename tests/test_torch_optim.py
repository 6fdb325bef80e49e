"""Port parity: every optimizer name of the JAX ``make_optimizer`` against optax.

``unirestore_torch/train/optim.py`` against ``unirestore_tpu/train/optim.py``
(optax 0.2.6) on one seeded tree with a 1-D leaf, a 128 x 192 matrix and a
conv kernel of 3 x 3 x 128 x 160 (HWIO in JAX, OIHW in the port), so that
``adafactor`` factors the moments of both and ``lamb`` / ``lars`` take a trust
ratio per leaf. Two updates with nonzero gradients and weight decay 0.1,
plain, and with global-norm clipping (below the gradients' norm), gradient
accumulation 2 and a OneCycle schedule. Tolerance: 1e-5 relative to each
leaf's largest value (the same fp32 arithmetic summed in another order; the
rules' fp32 powers of the decay rates are taken as XLA takes them). Also: the
zero-gradient decay rules of ``tests/test_train.py::test_optimizer_name_surface``
(decoupled decay masked off 1-D leaves; ``adafactor``'s unmasked decay moves a
leaf by ``weight_decay * p``), ``momentum`` from the YAML kwargs, an unknown
name, and each optimizer's state through a checkpoint. ``fit`` through the CLI
with each name is in ``tests/test_torch_optim_cli.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_bridge import to_np
from unirestore_torch.train import checkpoints as TCK
from unirestore_torch.train import optim as TOPT
from unirestore_tpu.train import optim as JOPT

torch.set_num_threads(2)
NAMES = ("adamw", "nadamw", "radam", "lamb", "lion", "adafactor", "lars", "sgdw",
         "adam", "nadam", "adamax", "sgd", "momentum", "rmsprop", "adagrad", "adadelta")
DECOUPLED_MASKED = ("adamw", "nadamw", "radam", "lamb", "lion", "lars", "sgdw")
SHAPES = {"norm//b": (40,), "lin//w": (128, 192), "conv//w": (3, 3, 128, 160)}
RTOL = 1e-5


def _to_port(name, x):
    """A JAX-layout leaf in the port's layout (conv kernels HWIO -> OIHW)."""
    x = np.asarray(x)
    return torch.tensor(x.transpose(3, 2, 0, 1) if x.ndim == 4 else x)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {k: (0.5 * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}


def _run_both(name, grads, clip=None, accum=1, sched=None, lr=1e-2, weight_decay=0.1,
              momentum=0.9):
    """Params after feeding ``grads`` (JAX layout) to both optimizers."""
    params = _tree(0)
    lr_j = JOPT.make_lr_schedule(sched, lr, 6) if sched else lr
    lr_t = TOPT.make_lr_schedule(sched, lr, 6) if sched else lr
    tx_j = JOPT.make_optimizer(name, lr=lr_j, weight_decay=weight_decay, momentum=momentum,
                               accum_iter=accum, grad_clip=clip)
    tx_t = TOPT.make_optimizer(name, lr=lr_t, weight_decay=weight_decay, momentum=momentum,
                               accum_iter=accum, grad_clip=clip)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    pt = {k: _to_port(k, v) for k, v in params.items()}
    sj, st = tx_j.init(pj), tx_t.init(pt)
    for g in grads:
        upd, sj = tx_j.update({k: jnp.asarray(v) for k, v in g.items()}, sj, pj)
        pj = optax.apply_updates(pj, upd)
        tx_t.update(st, pt, {k: _to_port(k, v) for k, v in g.items()})
    return params, {k: _to_port(k, v) for k, v in pj.items()}, pt, st


def _grads(n, seed=1, scale=1.0):
    rng = np.random.default_rng(seed)
    return [{k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
            for _ in range(n)]


def _assert_close(got, want, params=None, name=""):
    for k in SHAPES:
        w = to_np(want[k])
        np.testing.assert_allclose(to_np(got[k]), w, rtol=0, atol=RTOL * np.abs(w).max(),
                                   err_msg=f"{name} {k}")
        if params is not None:  # the updates moved every leaf
            assert not np.array_equal(w, to_np(_to_port(k, params[k]))), f"{name} {k}"


@pytest.mark.parametrize("case", ["plain", "clip_accum_onecycle"])
@pytest.mark.parametrize("name", NAMES)
def test_two_updates_match_optax(name, case):
    if case == "plain":
        params, want, got, _ = _run_both(name, _grads(2))
    else:  # the gradients' global norm is about 500: the clip always bites
        params, want, got, st = _run_both(name, _grads(4), clip=5.0, accum=2,
                                          sched="onecycle")
        assert st["count"] == 2 and st["mini_step"] == 0
    _assert_close(got, want, params, name)


@pytest.mark.parametrize("name", NAMES)
def test_zero_gradient_decay_follows_the_jax_masks(name):
    """``tests/test_train.py::test_optimizer_name_surface`` on both sides: ones,
    zero gradients, lr 1e-2, weight decay 0.1."""
    ones = {k: np.ones(s, np.float32) for k, s in SHAPES.items()}
    tx_j = JOPT.make_optimizer(name, lr=1e-2, weight_decay=0.1)
    tx_t = TOPT.make_optimizer(name, lr=1e-2, weight_decay=0.1)
    pj = {k: jnp.asarray(v) for k, v in ones.items()}
    upd, _ = tx_j.update({k: jnp.zeros_like(v) for k, v in pj.items()}, tx_j.init(pj), pj)
    want = {k: _to_port(k, v) for k, v in optax.apply_updates(pj, upd).items()}
    pt = {k: _to_port(k, v) for k, v in ones.items()}
    tx_t.update(tx_t.init(pt), pt, {k: torch.zeros_like(v) for k, v in pt.items()})
    _assert_close(pt, want, name=name)
    if name in DECOUPLED_MASKED:
        assert torch.equal(pt["norm//b"], torch.ones(SHAPES["norm//b"])), name
        assert float((pt["lin//w"] - 1).abs().max()) > 1e-6, name
    if name == "adafactor":  # unmasked, after the learning rate: p - 0.1 * p
        for k, v in pt.items():
            torch.testing.assert_close(v, torch.full_like(v, 0.9), rtol=1e-6, atol=0, msg=k)


@pytest.mark.parametrize("name", ["momentum", "sgd", "sgdw", "lars", "rmsprop"])
def test_momentum_reaches_the_trace(name):
    """``momentum`` from the YAML kwargs reaches every rule with a trace (it
    was dropped by ``build``): at 0.0 they follow JAX's momentum-free forms,
    and differ from the 0.9 default."""
    kw = {"opt": name, "base_lr": 1e-2, "base_bsz": 1, "weight_decay": 0.1}
    assert TOPT.build({**kw, "momentum": "0.0"}, None, 10, 1, 1, 1)[0].momentum == 0.0
    assert TOPT.build(kw, None, 10, 1, 1, 1)[0].momentum == 0.9
    params, want, got, _ = _run_both(name, _grads(2), momentum=0.0)
    _assert_close(got, want, params, name)
    _, default, _, _ = _run_both(name, _grads(2))
    assert not torch.equal(default["lin//w"], want["lin//w"])


def test_unknown_name_raises_with_the_sorted_list():
    with pytest.raises(ValueError) as port:
        TOPT.make_optimizer("fused_madgrad")
    with pytest.raises(ValueError) as ref:
        JOPT.make_optimizer("fused_madgrad")
    assert str(port.value) == str(ref.value)
    assert "'adadelta', 'adagrad', 'adam', 'adamax'" in str(port.value)


@pytest.mark.parametrize("name", NAMES)
def test_state_resumes_bit_equal_through_a_checkpoint(name, tmp_path):
    """One update at accumulation 2 plus half of the next, the state saved
    with ``checkpoints.save_checkpoint`` and restored into a fresh one; the
    rest of the run then gives the same bits."""
    grads = _grads(4, seed=7)
    tx = TOPT.make_optimizer(name, lr=1e-2, weight_decay=0.1, accum_iter=2, grad_clip=5.0)
    params = {k: _to_port(k, v) for k, v in _tree(3).items()}
    state = tx.init(params)
    for g in grads[:3]:
        tx.update(state, params, {k: _to_port(k, v) for k, v in g.items()})
    path = str(tmp_path / "opt.npz")
    TCK.save_checkpoint(path, params, step=3, opt_state=state)
    resumed = TCK.restore_opt_state(path, tx.init(params))
    twin = {k: v.clone() for k, v in params.items()}
    last = {k: _to_port(k, v) for k, v in grads[3].items()}
    assert tx.update(state, params, last) and tx.update(resumed, twin, last)
    for k in params:
        assert torch.equal(params[k], twin[k]), f"{name} {k}"
