"""Port parity: the train step's parts in turn (``train/steps.py:
make_train_step``, the JAX package's ``make_split_train_step``).

- Against ``chip_smoke.monolithic_step`` (``compute_losses``' sum
  differentiated once, the step's own optimizer tail), from the same
  parameters, batch and ``StepNoise`` (the tiny config's seeded init with
  every all-zero leaf filled, 64 px, batch 2): every logged loss,
  ``train/grad_norm``, every leaf and every optimizer slot after one update
  are bit-equal, in five stage cases (stage 1; stage 2 with a
  ``te_loss_fn``; joint MTL at task ``cls``; stage 3 ``tfa_prompts_only``;
  SPADE stage 1) under SGD with momentum 0 and under AdamW. Bit-equal, not
  close: each trained leaf's gradient comes from one loss, through the same
  operations in the same order, and the sum passes 1.0 to each loss.
- ``stop_after`` after each part leaves ``trainable`` and ``opt_state``
  bit-equal and logs only ``train/loss``: the mean of the hq latents after
  ``shared``, then the logged terms summed so far, bit-equal. An unknown
  part raises JAX's ``ValueError``; a spatial context is refused.
- Against JAX's ``make_split_train_step(..., donate=False)`` with JAX's own
  noise draws (``test_torch_train._jax_noise``), at 128 px batch 1
  (``test_torch_train.py``'s docstring says why 128 px): two stage-1 steps
  under AdamW (eps 1e-3) with losses at 1e-5 relative and leaves at 1e-5,
  as ``test_two_train_steps_match_jax_monolithic_step`` holds the step to
  JAX's monolithic one; the joint-MTL step under momentum-0 SGD at JAX's own
  split-test tolerance (rtol 2e-5, atol 2e-6); the logs of each
  ``stop_after`` at 1e-5 relative. The JAX parameters are the port's init in
  the JAX layout (the JAX init compiles for seconds a leaf shape).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import monolithic_step
from test_torch_bridge import to_np
from test_torch_eval import filled_init, jax_layout
from test_torch_spatial import _fake_context
from test_torch_train import _batch, _jax_noise
from unirestore_torch import bridge
from unirestore_torch.models import unirestore as TUR
from unirestore_torch.parallel import spatial as SP
from unirestore_torch.train import optim as TOPT
from unirestore_torch.train import steps as TS
from unirestore_tpu.models import unirestore as JUR
from unirestore_tpu.train import optim as JOPT
from unirestore_tpu.train import steps as JS

torch.set_num_threads(2)

TASKS = ("ir", "cls", "det")
# name: (stage, task, control type, with the test's te_loss_fn)
CASES = {
    "stage1": (dict(train_cfrm=True, train_cnet=True), "ir", "scedit", False),
    "stage2_te_loss": (dict(train_cfrm=False, train_cnet=False, train_tfa=True), "ir", "scedit",
                       True),
    "mtl_cls": (dict(train_cfrm=True, train_cnet=True, train_tfa=True, multi_task=True), "cls",
                "scedit", True),
    "stage3_prompts": (dict(train_cfrm=False, train_cnet=False, train_tfa=True,
                            tfa_prompts_only=True, multi_task=True), "det", "scedit", False),
    "spade_stage1": (dict(train_cfrm=True, train_cnet=True), "ir", "spade", False),
}
OPTIMIZERS = {"sgd": lambda: TOPT.make_optimizer("momentum", lr=1e-3, momentum=0.0,
                                                 weight_decay=0.0),
              "adamw": lambda: TOPT.AdamW(1e-3, weight_decay=1e-2, eps=1e-3)}


def te_fn_torch(preds, hq, gt, task):
    """The JAX split test's task loss (``tests/test_train.py``)."""
    if task == "ir":
        return 10.0 * torch.mean(torch.abs(preds - hq))
    return 0.1 * torch.mean(preds.float() ** 2)


def te_fn_jax(preds, hq, gt, task):
    if task == "ir":
        return 10.0 * jnp.mean(jnp.abs(preds - hq))
    return 0.1 * jnp.mean(preds.astype(jnp.float32) ** 2)


@functools.lru_cache(maxsize=None)
def _init(control_type):
    """(port config, JAX config, port trees) of the tiny model of ``control_type``."""
    use_tfa = control_type == "scedit"
    kw = dict(use_tfa=use_tfa, tasks=TASKS if use_tfa else ("ir",), control_type=control_type)
    ct = TUR.tiny_config(**kw)
    return ct, JUR.tiny_config(**kw), filled_init(ct, seed=21)


def _clone(tree):
    return bridge.unflatten_like({k: v.clone() for k, v in bridge.flatten(tree).items()}, tree)


def _inputs(ct, task, hw=64, b=2, seed=22):
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(rng.uniform(size=(b, hw, hw, 3)).astype(np.float32))
             for k in ("lq", "hq")}
    if task == "cls":
        batch["gt"] = torch.zeros(b, dtype=torch.int64)
    return batch, TS.draw_noise(ct, batch, torch.Generator().manual_seed(seed + 1))


def _run(make, name, opt, **kw):
    """One step of ``make`` on the case's init: (trainable, opt_state, logs, stage)."""
    stage_kw, task, control, te = CASES[name]
    ct, _, (frozen, trainable) = _init(control)
    stage = TS.StageConfig(**stage_kw)
    tx = OPTIMIZERS[opt]()
    trainable = _clone(trainable)
    state = tx.init(TS.trained_leaves(stage, trainable))
    step = make(frozen, ct, TUR.schedule(ct), stage, tx, task,
                te_loss_fn=te_fn_torch if te else None, **kw)
    assert step.task == task
    batch, noise = _inputs(ct, task)
    trainable, state, logs = step(trainable, state, batch, noise)
    return trainable, state, logs, stage


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


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
@pytest.mark.parametrize("name", list(CASES))
def test_split_step_equals_the_monolithic_step(name, opt):
    mono, mono_state, mono_logs, stage = _run(monolithic_step, name, opt)
    split, split_state, split_logs, _ = _run(TS.make_train_step, name, opt)
    _assert_bit_equal(mono_logs, split_logs, "log")
    assert split_logs["train/grad_norm"] > 0 and split_logs["train/loss"] > 0
    _assert_bit_equal(bridge.flatten(mono), bridge.flatten(split), "leaf")
    _assert_bit_equal(_flat_state(mono_state), _flat_state(split_state), "optimizer state")
    # only trained leaves moved; under AdamW every trained family did (at lr
    # 1e-3, SGD moves the stage-3 prompts by less than an fp32 ulp)
    before = bridge.flatten(_init(CASES[name][2])[2][1])
    mask = bridge.flatten(TS.trainable_filter(stage, split))
    moved = [k for k, p in bridge.flatten(split).items() if not torch.equal(p, before[k])]
    assert all(mask[k] for k in moved)
    if opt == "adamw":
        assert {k.split("//")[0] for k in moved} == {k.split("//")[0] for k, m in mask.items() if m}


def _truncated_value(part, mono_logs, ct, task, frozen, trainable):
    """What the step truncated after ``part`` logs, from the whole step's terms."""
    if part == "shared":
        batch, noise = _inputs(ct, task)
        h0, _ = TUR.encode(frozen, trainable, TS.with_remat(ct), batch["hq"], noise=noise.hq,
                           enable_fr=False)
        return h0.mean()
    terms = {"fr": ["train/loss_frenc"], "cn": ["train/loss_frenc", "train/loss_cnet"],
             "te": ["train/loss_frenc", "train/loss_cnet", f"train/loss_{task}"]}[part]
    loss = torch.zeros((), dtype=torch.float32)
    for k in terms:
        loss = loss + mono_logs[k]
    return loss


@pytest.mark.parametrize("part", TS.SPLIT_PARTS)
def test_stop_after_changes_nothing_and_logs_the_loss_so_far(part):
    name, opt = "mtl_cls", "adamw"
    _, _, mono_logs, stage = _run(monolithic_step, name, opt)
    stage_kw, task, control, _ = CASES[name]
    ct, _, (frozen, trainable) = _init(control)
    tx = OPTIMIZERS[opt]()
    tr = _clone(trainable)
    state = tx.init(TS.trained_leaves(stage, tr))
    state_before = {k: v.clone() if isinstance(v, torch.Tensor) else v
                    for k, v in _flat_state(state).items()}
    step = TS.make_train_step(frozen, ct, TUR.schedule(ct), stage, tx, task,
                              te_loss_fn=te_fn_torch, stop_after=part)
    batch, noise = _inputs(ct, task)
    out_tr, out_state, logs = step(tr, state, batch, noise)
    assert out_tr is tr and out_state is state
    _assert_bit_equal(bridge.flatten(trainable), bridge.flatten(tr), "leaf")
    _assert_bit_equal(state_before, _flat_state(state), "optimizer state")
    assert list(logs) == ["train/loss"]
    want = _truncated_value(part, mono_logs, ct, task, frozen, trainable)
    assert torch.equal(logs["train/loss"], want), (part, logs["train/loss"], want)


def test_an_unknown_part_raises_as_jax_does_and_a_spatial_context_is_refused():
    ct, cj, (frozen, trainable) = _init("scedit")
    stage = TS.StageConfig(train_cfrm=True, train_cnet=True)
    tx = OPTIMIZERS["sgd"]()
    assert TS.make_split_train_step is TS.make_train_step  # JAX's name for the step
    with pytest.raises(ValueError) as t_err:
        TS.make_train_step(frozen, ct, TUR.schedule(ct), stage, tx, "ir", stop_after="apply")
    with pytest.raises(ValueError) as j_err:
        JS.make_split_train_step(None, cj, None, JS.StageConfig(), None, "ir",
                                 stop_after="apply")
    assert str(t_err.value) == str(j_err.value)
    step = TS.make_train_step(frozen, ct, TUR.schedule(ct), stage, tx, "ir")
    batch, noise = _inputs(ct, "ir")
    with SP.partition(_fake_context()):
        with pytest.raises(NotImplementedError, match="the train step does not run"):
            step(trainable, tx.init(TS.trained_leaves(stage, trainable)), batch, noise)


# -- against JAX's split step ---------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_trees(control_type="scedit"):
    _, _, (frozen, trainable) = _init(control_type)
    return jax_layout(frozen), jax_layout(trainable)


def _port_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _assert_leaves_match(port, jax_tree, atol, rtol=0.0):
    want = bridge.flatten(bridge.load_tree(jax.tree.map(np.asarray, jax_tree), port, device="cpu"))
    for k, p in bridge.flatten(port).items():
        np.testing.assert_allclose(to_np(p), to_np(want[k]), atol=atol, rtol=rtol, err_msg=k)


def test_two_stage1_steps_match_the_jax_split_step():
    ct, cj, (frozen, trainable) = _init("scedit")
    fj, tj = _jax_trees()
    stage_kw = CASES["stage1"][0]
    tx_j = optax.adamw(1e-3, eps=1e-3, weight_decay=1e-2, mask=JOPT._wd_mask)
    step_j = JS.make_split_train_step(fj, cj, JUR.schedule(cj), JS.StageConfig(**stage_kw), tx_j,
                                      "ir", donate=False)
    stage = TS.StageConfig(**stage_kw)
    tx_t = TOPT.AdamW(1e-3, weight_decay=1e-2, eps=1e-3)
    tt = _clone(trainable)
    step_t = TS.make_train_step(frozen, ct, TUR.schedule(ct), stage, tx_t, "ir")
    state_j, state_t = tx_j.init(tj), tx_t.init(TS.trained_leaves(stage, tt))
    for i in range(2):
        batch, rng = _batch(30 + i, b=1, hw=128), jax.random.PRNGKey(40 + i)
        tj, state_j, logs_j = step_j(tj, state_j, batch, rng)
        tt, state_t, logs_t = step_t(tt, state_t, _port_batch(batch), _jax_noise(cj, batch, rng))
        assert set(logs_j) == set(logs_t) - {"train/grad_norm"}
        for k in logs_j:
            np.testing.assert_allclose(logs_t[k].item(), float(logs_j[k]), rtol=1e-5,
                                       err_msg=f"step {i} {k}")
    _assert_leaves_match(tt, tj, atol=1e-5)


def test_joint_mtl_step_matches_the_jax_split_step():
    ct, cj, (frozen, trainable) = _init("scedit")
    fj, tj = _jax_trees()
    stage_kw = CASES["mtl_cls"][0]
    tx_j = JOPT.make_optimizer(opt="momentum", lr=1e-3, momentum=0.0, weight_decay=0.0)
    step_j = JS.make_split_train_step(fj, cj, JUR.schedule(cj), JS.StageConfig(**stage_kw), tx_j,
                                      "cls", te_loss_fn=te_fn_jax, donate=False)
    stage = TS.StageConfig(**stage_kw)
    tx_t = OPTIMIZERS["sgd"]()
    tt = _clone(trainable)
    step_t = TS.make_train_step(frozen, ct, TUR.schedule(ct), stage, tx_t, "cls",
                                te_loss_fn=te_fn_torch)
    batch, rng = _batch(50, b=1, hw=128), jax.random.PRNGKey(51)
    batch["gt"] = np.zeros((1,), np.int32)
    tj, _, logs_j = step_j(tj, tx_j.init(tj), batch, rng)
    tt, _, logs_t = step_t(tt, tx_t.init(TS.trained_leaves(stage, tt)), _port_batch(batch),
                           _jax_noise(cj, batch, rng))
    assert set(logs_j) == set(logs_t) - {"train/grad_norm"}
    for k in logs_j:
        np.testing.assert_allclose(logs_t[k].item(), float(logs_j[k]), rtol=2e-5, atol=1e-6,
                                   err_msg=k)
    _assert_leaves_match(tt, tj, atol=2e-6, rtol=2e-5)


@pytest.mark.parametrize("part", TS.SPLIT_PARTS)
def test_stop_after_logs_match_the_jax_split_step(part):
    ct, cj, (frozen, trainable) = _init("scedit")
    fj, tj = _jax_trees()
    stage_kw = CASES["stage1"][0]
    tx_j = JOPT.make_optimizer(opt="momentum", lr=1e-3, momentum=0.0, weight_decay=0.0)
    step_j = JS.make_split_train_step(fj, cj, JUR.schedule(cj), JS.StageConfig(**stage_kw), tx_j,
                                      "ir", donate=False, stop_after=part)
    stage = TS.StageConfig(**stage_kw)
    tx_t = OPTIMIZERS["sgd"]()
    step_t = TS.make_train_step(frozen, ct, TUR.schedule(ct), stage, tx_t, "ir",
                                stop_after=part)
    batch, rng = _batch(60, b=1, hw=128), jax.random.PRNGKey(61)
    _, _, logs_j = step_j(tj, tx_j.init(tj), batch, rng)
    _, _, logs_t = step_t(trainable, tx_t.init(TS.trained_leaves(stage, trainable)),
                          _port_batch(batch), _jax_noise(cj, batch, rng))
    assert list(logs_t) == list(logs_j) == ["train/loss"]
    np.testing.assert_allclose(logs_t["train/loss"].item(), float(logs_j["train/loss"]),
                               rtol=1e-5)
