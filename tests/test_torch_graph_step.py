"""The graph-captured train step's host side and bodies, on the CPU.

CUDA graphs run only on the card (``chip_smoke.py`` phase 19 holds
``graphs.GraphedTrainStep`` to the eager step bit for bit at full width).
Here:

- every optimizer with its per-update scalars as 0-dim fp32 tensors (the
  static buffer ``graphs.ScalarBuffer`` the graph route fills before each
  replay; ``Optimizer.advance`` then ``Optimizer.apply``) is bit-equal to
  the host-float path (``Optimizer.update``) over three updates, plain and
  with accumulation 2, a clip that always triggers and a OneCycle schedule,
  and within ``tests/test_torch_optim.py``'s 1e-5 of optax;
- the two step bodies the graph route captures (``steps.make_step_parts``,
  then ``Optimizer.advance`` and ``steps.optimizer_tail`` on a
  ``ScalarBuffer``), run eagerly, are bit-equal to ``make_train_step`` over
  an accumulating and an applying micro-step (AdamW, clip triggering): logs,
  every trainable leaf and every optimizer slot; and within 1e-5 of JAX's
  ``make_split_train_step`` (losses relative, leaves absolute), at stage 1
  and at each stage-2 task (ir, cls, seg), ``tiny_config()`` at 128 px;
- ``GraphedTrainStep`` refuses the CPU, a process group, FSDP shards, a
  spatial context and the det task, each with its own error.
"""

import functools

import jax
import numpy as np
import optax
import pytest
import torch

from test_torch_bridge import to_np
from test_torch_eval import filled_init, jax_layout
from test_torch_optim import NAMES, RTOL, SHAPES, _assert_close, _grads, _to_port, _tree
from test_torch_spatial import _fake_context
from test_torch_split_step import te_fn_jax, te_fn_torch
from test_torch_train import _batch, _jax_noise
from unirestore_torch import bridge
from unirestore_torch import graphs as GR
from unirestore_torch.models import unirestore as TUR
from unirestore_torch.parallel import fsdp as FSDP
from unirestore_torch.parallel import spatial as SP
from unirestore_torch.train import optim as TOPT
from unirestore_torch.train import steps as TS
from unirestore_tpu.models import unirestore as JUR
from unirestore_tpu.train import optim as JOPT
from unirestore_tpu.train import steps as JS

torch.set_num_threads(2)

# -- the optimizers' per-update scalars as device values -----------------------

CASES = {"plain": dict(n=3, accum=1, clip=None, sched=None),
         # the gradients' global norm is about 500: the clip always bites
         "accum2_clip_onecycle": dict(n=6, accum=2, clip=5.0, sched="onecycle")}


def _optimizer(name, accum, clip, sched):
    lr = TOPT.make_lr_schedule(sched, 1e-2, 6) if sched else 1e-2
    return TOPT.make_optimizer(name, lr=lr, weight_decay=0.1, accum_iter=accum, grad_clip=clip)


def _run(name, grads, accum, clip, sched, device_scalars):
    """Params and state after feeding ``grads`` (JAX layout) to the port's
    optimizer, by ``update`` or by ``advance`` + ``apply`` on a ScalarBuffer."""
    tx = _optimizer(name, accum, clip, sched)
    params = {k: _to_port(k, v) for k, v in _tree(0).items()}
    state = tx.init(params)
    buffers = {}
    for g in grads:
        g = {k: _to_port(k, v) for k, v in g.items()}
        if not device_scalars:
            tx.update(state, params, g)
            continue
        applies, host = tx.advance(state)
        buf = buffers.setdefault(applies, GR.ScalarBuffer(host, "cpu"))
        buf.fill(host)
        assert all(v.dim() == 0 and v.dtype == torch.float32 for v in buf.views.values())
        tx.apply(state, params, g, applies, buf.views)
    return params, state


def _flat_state(state, prefix=""):
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(_flat_state(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _assert_bit_equal(a: dict, b: dict, what: str):
    assert a.keys() == b.keys(), what
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), f"{what} {k}: max |diff| {(a[k] - b[k]).abs().max()}"
        else:
            assert a[k] == b[k], f"{what} {k}"


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", NAMES)
def test_device_scalars_are_bit_equal_to_host_floats_and_close_to_optax(name, case):
    kw = CASES[case]
    grads = _grads(kw["n"])
    run = functools.partial(_run, name, grads, kw["accum"], kw["clip"], kw["sched"])
    host_p, host_s = run(device_scalars=False)
    dev_p, dev_s = run(device_scalars=True)
    _assert_bit_equal(host_p, dev_p, f"{name} leaf")
    _assert_bit_equal(_flat_state(host_s), _flat_state(dev_s), f"{name} state")
    assert dev_s["count"] == 3 and dev_s["mini_step"] == 0
    # and optax's updates within the optimizer tests' tolerance
    lr = JOPT.make_lr_schedule(kw["sched"], 1e-2, 6) if kw["sched"] else 1e-2
    tx_j = JOPT.make_optimizer(name, lr=lr, weight_decay=0.1, accum_iter=kw["accum"],
                               grad_clip=kw["clip"])
    params = _tree(0)
    pj = {k: jax.numpy.asarray(v) for k, v in params.items()}
    sj = tx_j.init(pj)
    for g in grads:
        upd, sj = tx_j.update({k: jax.numpy.asarray(v) for k, v in g.items()}, sj, pj)
        pj = optax.apply_updates(pj, upd)
    _assert_close(dev_p, {k: _to_port(k, v) for k, v in pj.items()}, params, name)
    assert RTOL == 1e-5


def test_advance_moves_the_counts_and_names_the_same_scalars_every_update():
    tx = _optimizer("radam", accum=2, clip=None, sched="onecycle")
    state = tx.init({k: _to_port(k, v) for k, v in _tree(0).items()})
    forms = []
    for _ in range(8):
        applies, host = tx.advance(state)
        forms.append((applies, tuple(sorted(host))))
    assert state["count"] == 4 and state["mini_step"] == 0
    assert forms[0] == (False, ("acc", "acc_inv"))
    assert {f for f in forms if f[0]} == {forms[1]}  # RAdam's rect and r at every update
    assert {"lr", "r", "rect", "d1", "d1_inv", "d2", "d2_inv"} <= set(forms[1][1])
    buf = GR.ScalarBuffer(dict.fromkeys(forms[1][1], 0.0), "cpu")
    with pytest.raises(ValueError, match="per-update scalars"):
        buf.fill({"lr": 1.0})


# -- the step bodies ---------------------------------------------------------------

STEP_TASKS = ("ir", "cls", "seg")
STAGES = {"stage1": (dict(train_cfrm=True, train_cnet=True), "ir"),
          **{f"stage2_{t}": (dict(train_cfrm=False, train_cnet=False, train_tfa=True,
                                  multi_task=True), t) for t in STEP_TASKS}}
HW = 128  # test_torch_train.py's docstring says why the JAX comparisons take 128 px


@functools.lru_cache(maxsize=None)
def _init():
    kw = dict(use_tfa=True, tasks=STEP_TASKS, control_type="scedit")
    ct = TUR.tiny_config(**kw)
    return ct, JUR.tiny_config(**kw), filled_init(ct, seed=23)


def _clone(tree):
    return bridge.unflatten_like({k: v.clone() for k, v in bridge.flatten(tree).items()}, tree)


def _bodies_step(frozen, cfg, sched, stage, tx, task, te_loss_fn):
    """The route ``GraphedTrainStep`` replays, run eagerly: the parts body,
    the host's ``advance``, the scalars copied into a static buffer, the tail
    body of the call's form."""
    parts = TS.make_step_parts(TS.with_remat(cfg), sched, stage, task, te_loss_fn)
    buffers = {}

    def step(trainable, opt_state, batch, noise):
        logs, grads = parts(frozen, trainable, batch, noise)
        applies, host = tx.advance(opt_state)
        buf = buffers.setdefault(applies, GR.ScalarBuffer(host, "cpu"))
        buf.fill(host)
        logs["train/grad_norm"] = TS.optimizer_tail(
            tx, opt_state, TS.trained_leaves(stage, trainable), grads, (applies, buf.views))
        return trainable, opt_state, logs

    return step


def _inputs(ct, task, seed):
    batch = {k: torch.from_numpy(v) for k, v in _batch(seed, b=1, hw=HW).items()}
    if task == "cls":
        batch["gt"] = torch.zeros(1, dtype=torch.int64)
    elif task == "seg":
        batch["gt"] = torch.zeros((1, HW, HW), dtype=torch.int64)
    return batch, TS.draw_noise(ct, batch, torch.Generator().manual_seed(seed + 1))


@pytest.mark.parametrize("name", list(STAGES))
def test_step_bodies_are_bit_equal_to_make_train_step(name):
    """An accumulating and an applying micro-step (AdamW at accumulation 2,
    a clip that triggers) by each route from one state."""
    stage_kw, task = STAGES[name]
    ct, _, (frozen, trainable) = _init()
    stage = TS.StageConfig(**stage_kw)
    out = {}
    for route, make in (("eager", TS.make_train_step), ("bodies", _bodies_step)):
        tx = TOPT.AdamW(1e-3, weight_decay=1e-2, eps=1e-3, accum_iter=2, grad_clip=1e-3)
        tr = _clone(trainable)
        state = tx.init(TS.trained_leaves(stage, tr))
        step = make(frozen, ct, TUR.schedule(ct), stage, tx, task, te_loss_fn=te_fn_torch)
        logs = [step(tr, state, *_inputs(ct, task, 70 + i))[2] for i in range(2)]
        out[route] = (logs, tr, state)
    for i in range(2):
        _assert_bit_equal(out["eager"][0][i], out["bodies"][0][i], f"micro-step {i + 1} log")
    assert out["bodies"][0][1]["train/grad_norm"] > 1e-3  # the clip triggered
    _assert_bit_equal(bridge.flatten(out["eager"][1]), bridge.flatten(out["bodies"][1]), "leaf")
    _assert_bit_equal(_flat_state(out["eager"][2]), _flat_state(out["bodies"][2]), "state")
    before = bridge.flatten(trainable)
    moved = {k.split("//")[0] for k, v in bridge.flatten(out["bodies"][1]).items()
             if not torch.equal(v, before[k])}
    assert moved == ({"cfrm", "controller", "control"} if name == "stage1" else {"tfa"})


@functools.lru_cache(maxsize=None)
def _jax_trees():
    _, _, (frozen, trainable) = _init()
    return jax_layout(frozen), jax_layout(trainable)


@pytest.mark.parametrize("name", list(STAGES))
def test_step_bodies_match_the_jax_split_step(name):
    """One AdamW update (eps 1e-3) from the same parameters, batch and noise:
    losses within 1e-5 relative, every leaf within 1e-5."""
    stage_kw, task = STAGES[name]
    ct, cj, (frozen, trainable) = _init()
    fj, tj = _jax_trees()
    tx_j = optax.adamw(1e-3, eps=1e-3, weight_decay=1e-2, mask=JOPT._wd_mask)
    step_j = JS.make_split_train_step(fj, cj, JUR.schedule(cj), JS.StageConfig(**stage_kw), tx_j,
                                      task, te_loss_fn=te_fn_jax, donate=False)
    stage = TS.StageConfig(**stage_kw)
    tx_t = TOPT.AdamW(1e-3, weight_decay=1e-2, eps=1e-3)
    tt = _clone(trainable)
    step_t = _bodies_step(frozen, ct, TUR.schedule(ct), stage, tx_t, task, te_fn_torch)
    batch, rng = _batch(80, b=1, hw=HW), jax.random.PRNGKey(81)
    if task == "cls":
        batch["gt"] = np.zeros((1,), np.int32)
    elif task == "seg":
        batch["gt"] = np.zeros((1, HW, HW), np.int32)
    tj, _, logs_j = step_j(tj, tx_j.init(tj), batch, rng)
    port_batch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    tt, _, logs_t = step_t(tt, tx_t.init(TS.trained_leaves(stage, tt)), port_batch,
                           _jax_noise(cj, batch, rng))
    assert set(logs_j) == set(logs_t) - {"train/grad_norm"}
    for k in logs_j:
        np.testing.assert_allclose(logs_t[k].item(), float(logs_j[k]), rtol=1e-5, err_msg=k)
    want = bridge.flatten(bridge.load_tree(jax.tree.map(np.asarray, tj), tt, device="cpu"))
    for k, p in bridge.flatten(tt).items():
        np.testing.assert_allclose(to_np(p), to_np(want[k]), atol=1e-5, rtol=0, err_msg=k)


# -- refusals ------------------------------------------------------------------------


def _graphed(**kw):
    ct, _, (frozen, _) = _init()
    stage = TS.StageConfig(train_cfrm=True, train_cnet=True)
    args = dict(frozen=frozen, cfg=ct, sched=TUR.schedule(ct), stage=stage,
                tx=TOPT.AdamW(1e-3), task="ir", device="cpu")
    return GR.GraphedTrainStep(**{**args, **kw})


def _sharded(tree):
    """``tree`` with its first leaf a ``Shard`` of one block."""
    flat = bridge.flatten(tree)
    k = next(iter(flat))
    flat[k] = FSDP.shard_tensor(flat[k], 0, 1, 0)
    return bridge.unflatten_like(flat, tree)


def test_graphed_train_step_refuses_what_it_cannot_capture():
    with pytest.raises(ValueError, match="GraphedTrainStep needs a CUDA device, got cpu"):
        _graphed()
    with pytest.raises(ValueError, match="does not run under a process group"):
        _graphed(group=object())
    with pytest.raises(ValueError, match="does not take FSDP shards"):
        _graphed(frozen=_sharded(_init()[2][0]))
    with pytest.raises(NotImplementedError, match="no route for the det task"):
        _graphed(task="det")
    with SP.partition(_fake_context()):
        with pytest.raises(NotImplementedError,
                           match="GraphedTrainStep does not run on height-sharded"):
            _graphed()
