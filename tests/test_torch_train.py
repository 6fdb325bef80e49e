"""Port parity: the training step (losses, gradients, optimizer, checkpoints).

The JAX side draws its noise from its key; the tests recompute those draws
(``k_hq, k_lq, k_diff = split(rng, 3)``; ``k_t, k_n = split(k_diff)``) and
hand them to the port as ``StepNoise``. fp32 on the CPU, tiny configs. The
parameters are the JAX init with every all-zero leaf (zero convs, NAF
beta/gamma, TFA prompts, the null embedding) filled with N(0, 0.05), so every
adapter path moves the loss. Stage 1 runs at 128 px (batch 1): at 64 px the tiny
Controller's deepest level is 1x1 with two channels per GroupNorm group, and
fp32 gradients there lose two to three digits against fp64 in either
framework. Tolerances:

- losses: relative 1e-5 (the forward's 1e-6-level summation-order
  differences between XLA:CPU and oneDNN);
- gradients: 1e-4 of the largest gradient of the leaf's family (cfrm,
  controller, control, tfa), absolute, plus 1e-4 relative. Leaves whose true
  gradient is zero up to rounding (a bias feeding a GroupNorm) hold fp32
  noise in both frameworks, so the scale is the family's, not the leaf's;
- parameters after two AdamW steps: 1e-5. The optimizers take eps = 1e-3:
  with eps = 1e-8 the first Adam update is lr * sign(g), and a leaf whose
  true gradient is zero (fp32 noise of 1e-7) moves by +-lr at random in
  either framework;
- optimizer alone against optax: 1e-6 (a few fp32 ulps of the O(1)
  parameters after six steps of the same arithmetic in another order).

The stage-2 ``mtl`` losses run the tiny model at 64 px with the real-width
critics (ResNet-50, DeepLabV3+-ResNet-50; the JAX critics with random BN
statistics, ``test_torch_tasks.jax_critics``, carried across): losses at 1e-5
relative and TFA gradients at 1e-4 of each family's largest, as above. The
same comparison must fail when the port leaves out the auxiliary IR decode
of a ``cls`` batch.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_bridge import to_np
from test_torch_eval import filled_init
from test_torch_tasks import jax_critics
from unirestore_torch import bridge
from unirestore_torch.models import unirestore as TUR
from unirestore_torch.nn import remat as TRM
from unirestore_torch.train import checkpoints as TCK
from unirestore_torch.train import optim as TOPT
from unirestore_torch.train import engine as TE
from unirestore_torch.train import steps as TS
from unirestore_tpu.models import unirestore as JUR
from unirestore_tpu.train import checkpoints as JCK
from unirestore_tpu.train import engine as JE
from unirestore_tpu.train import optim as JOPT
from unirestore_tpu.train import steps as JS

torch.set_num_threads(2)

STAGES = {
    "stage1": (dict(train_cfrm=True, train_cnet=True, train_tfa=False), "ir"),
    "stage2_ir": (dict(train_cfrm=False, train_cnet=False, train_tfa=True), "ir"),
    "stage3_prompts": (dict(train_cfrm=False, train_cnet=False, train_tfa=True,
                            tfa_prompts_only=True), "det"),
}


def _setup(use_tfa, seed=0, tasks=("ir", "det")):
    cj = JUR.tiny_config(use_tfa=use_tfa, tasks=tasks)
    ct = TUR.tiny_config(use_tfa=use_tfa, tasks=tasks)
    frozen, trainable = JUR.init(jax.random.PRNGKey(seed), cj)
    rng = np.random.default_rng(seed + 1)

    def fill(x):
        x = np.asarray(x, np.float32)
        return x if x.any() else (0.05 * rng.standard_normal(x.shape)).astype(np.float32)

    frozen, trainable = jax.tree.map(fill, frozen), jax.tree.map(fill, trainable)
    ft, tt = bridge.from_jax(frozen, trainable, ct, device="cpu")
    return cj, ct, (frozen, trainable), (ft, tt)


def _batch(seed, b=2, hw=64):
    rng = np.random.default_rng(seed)
    return {"lq": rng.uniform(size=(b, hw, hw, 3)).astype(np.float32),
            "hq": rng.uniform(size=(b, hw, hw, 3)).astype(np.float32)}


def _jax_noise(cfg, batch, rng):
    """The draws JAX ``compute_losses`` makes from ``rng``, as ``StepNoise``."""
    b, h, w, _ = batch["hq"].shape
    shape = (b, h // 8, w // 8, cfg.vae.latent_channels)
    k_hq, k_lq, k_diff = jax.random.split(rng, 3)
    k_t, k_n = jax.random.split(k_diff)
    idx = np.asarray(jax.random.randint(k_t, (b,), 0, len(JUR.TRAIN_TIMESTEPS)))

    def t(x):
        return torch.tensor(np.asarray(x))

    return TS.StepNoise(hq=t(jax.random.normal(k_hq, shape)), lq=t(jax.random.normal(k_lq, shape)),
                        diffusion=t(jax.random.normal(k_n, shape)),
                        timesteps=torch.tensor(np.asarray(JUR.TRAIN_TIMESTEPS)[idx],
                                               dtype=torch.int32))


def _port_grads(ft, tt, ct, stage, batch, noise, task, te_loss_fn=None):
    leaves = bridge.flatten(tt)
    for p in leaves.values():
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, logs = TS.compute_losses(ft, tt, ct, TUR.schedule(ct), stage, tb, noise, task,
                                   te_loss_fn)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    for p in leaves.values():
        p.requires_grad_(False)
    return loss, logs, {k: torch.zeros_like(p) if g is None else g
                        for (k, p), g in zip(leaves.items(), grads)}


def _assert_losses_and_grads_match(stage_kw, task, tt, loss, logs, grads, loss_j, logs_j,
                                   grads_j):
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    assert logs.keys() == logs_j.keys()
    for k in logs:
        np.testing.assert_allclose(logs[k].item(), float(logs_j[k]), rtol=1e-5, err_msg=k)

    want = bridge.flatten(bridge.load_tree(jax.tree.map(np.asarray, grads_j), tt,
                                           device="cpu"))
    assert want.keys() == grads.keys()
    mask = bridge.flatten(TS.trainable_filter(TS.StageConfig(**stage_kw), tt))
    scale = {}
    for k, ref in want.items():
        fam = k.split("//")[0]
        scale[fam] = max(scale.get(fam, 0.0), float(ref.abs().max()))
    for k, g in grads.items():
        fam = k.split("//")[0]
        np.testing.assert_allclose(to_np(g), to_np(want[k]), rtol=1e-4,
                                   atol=1e-4 * scale[fam] + 1e-12, err_msg=k)
        other_prompt = k.startswith("tfa//task_prompts//") and not k.endswith("//" + task)
        if mask[k] and not other_prompt:
            assert float(want[k].abs().max()) > 0, f"{k}: a trained leaf got no gradient"


@pytest.mark.parametrize("name", list(STAGES))
def test_compute_losses_and_grads_match_jax(name):
    stage_kw, task = STAGES[name]
    cj, ct, (fj, tj), (ft, tt) = _setup(use_tfa=True)
    batch = _batch(3, b=1, hw=128) if name == "stage1" else _batch(3)
    rng = jax.random.PRNGKey(4)
    sched = JUR.schedule(cj)
    fn = jax.jit(jax.value_and_grad(
        lambda tr, b, r: JS.compute_losses(fj, tr, cj, sched, JS.StageConfig(**stage_kw),
                                           b, r, task), has_aux=True))
    (loss_j, logs_j), grads_j = fn(tj, batch, rng)

    loss, logs, grads = _port_grads(ft, tt, ct, TS.StageConfig(**stage_kw), batch,
                                    _jax_noise(cj, batch, rng), task)
    _assert_losses_and_grads_match(stage_kw, task, tt, loss, logs, grads, loss_j, logs_j,
                                   grads_j)


MTL_STAGE = dict(train_cfrm=False, train_cnet=False, train_tfa=True, multi_task=True)


def _mtl_batch(task, seed=3):
    batch = _batch(seed, b=1)
    rng = np.random.default_rng(seed + 100)
    if task == "cls":
        batch["gt"] = np.array([417])
    elif task == "seg":
        gt = rng.integers(0, 19, (1, 64, 64))
        gt[:, :8] = 255
        batch["gt"] = gt
    return batch


@functools.lru_cache(maxsize=None)
def _mtl_setup():
    """The tiny mtl model from the port's seeded init with its zero leaves
    filled (the JAX init costs seconds of compiles), and the critics."""
    tasks = ("ir", "cls", "seg")
    cj, ct = JUR.tiny_config(use_tfa=True, tasks=tasks), TUR.tiny_config(use_tfa=True, tasks=tasks)
    port_pair = filled_init(ct, seed=2)
    jax_pair = tuple(jax.tree.map(jnp.asarray, bridge.to_numpy_tree(t)) for t in port_pair)
    critics = jax_critics()
    return (cj, ct, jax_pair, port_pair, jax.tree.map(jnp.asarray, critics),
            bridge.critics_from_jax(critics, device="cpu"))


@functools.lru_cache(maxsize=None)
def _mtl_jax(task):
    cj, _, (fj, tj), _, jcrit, _ = _mtl_setup()
    batch, rng = _mtl_batch(task), jax.random.PRNGKey(6)
    # the critics enter as arguments: closed over, XLA would fold them as constants
    fn = jax.jit(jax.value_and_grad(
        lambda tr, crit, b, r: JS.compute_losses(fj, tr, cj, JUR.schedule(cj),
                                                 JS.StageConfig(**MTL_STAGE), b, r, task,
                                                 te_loss_fn=JE.make_te_loss_fn("mtl", crit)),
        has_aux=True))
    (loss_j, logs_j), grads_j = fn(tj, jcrit, batch, rng)
    return batch, rng, loss_j, logs_j, grads_j


def _mtl_compare(task, port_stage):
    cj, ct, _, (ft, tt), _, tcrit = _mtl_setup()
    batch, rng, loss_j, logs_j, grads_j = _mtl_jax(task)
    loss, logs, grads = _port_grads(ft, tt, ct, port_stage, batch, _jax_noise(cj, batch, rng),
                                    task, TE.make_te_loss_fn("mtl", tcrit))
    _assert_losses_and_grads_match(MTL_STAGE, task, tt, loss, logs, grads, loss_j, logs_j,
                                   grads_j)


@pytest.mark.parametrize("task", ["ir", "cls", "seg"])
def test_mtl_losses_and_grads_through_the_critics_match_jax(task):
    _mtl_compare(task, TS.StageConfig(**MTL_STAGE))


def test_mtl_parity_catches_a_left_out_auxiliary_decode():
    left_out = dataclasses.replace(TS.StageConfig(**MTL_STAGE), multi_task=False)
    with pytest.raises(AssertionError):
        _mtl_compare("cls", left_out)


def test_two_train_steps_match_jax_monolithic_step():
    cj, ct, (fj, tj), (ft, tt) = _setup(use_tfa=True, seed=5)  # tfa stays untrained
    stage_kw = STAGES["stage1"][0]
    tx_j = optax.adamw(1e-3, eps=1e-3, weight_decay=1e-2, mask=JOPT._wd_mask)
    step_j = JS.make_train_step(fj, cj, JUR.schedule(cj), JS.StageConfig(**stage_kw), tx_j,
                                "ir", donate=False)
    tx_t = TOPT.AdamW(1e-3, weight_decay=1e-2, eps=1e-3)
    stage = TS.StageConfig(**stage_kw)
    step_t = TS.make_train_step(ft, ct, TUR.schedule(ct), stage, tx_t, "ir")

    before = {k: v.clone() for k, v in bridge.flatten(tt).items()}
    state_j, state_t = tx_j.init(tj), tx_t.init(TS.trained_leaves(stage, tt))
    for i in range(2):
        batch, rng = _batch(10 + i, b=1, hw=128), jax.random.PRNGKey(20 + i)
        tj, state_j, logs_j = step_j(tj, state_j, batch, rng)
        tt, state_t, logs_t = step_t(tt, state_t, {k: torch.from_numpy(v) for k, v in
                                                   batch.items()}, _jax_noise(cj, batch, rng))
        np.testing.assert_allclose(logs_t["train/loss"].item(), float(logs_j["train/loss"]),
                                   rtol=1e-5)
    want = bridge.flatten(bridge.load_tree(jax.tree.map(np.asarray, tj), tt, device="cpu"))
    mask = bridge.flatten(TS.trainable_filter(stage, tt))
    moved = set()
    for k, p in bridge.flatten(tt).items():
        np.testing.assert_allclose(to_np(p), to_np(want[k]), atol=1e-5, rtol=0, err_msg=k)
        if not mask[k]:
            assert torch.equal(p, before[k]), f"{k}: untrained leaf changed"
        elif not torch.equal(p, before[k]):
            moved.add(k.split("//")[0])
    assert moved == {"cfrm", "controller", "control"}


@pytest.mark.parametrize("sched,kw", [("onecycle", {}), ("onecycle", {"pct_start": 0.3}),
                                      ("step", {"step_size": 3, "gamma": 0.5}), (None, {})])
def test_lr_schedules_match_optax(sched, kw):
    ours = TOPT.make_lr_schedule(sched, 1e-3, 20, **kw)
    ref = JOPT.make_lr_schedule(sched, 1e-3, 20, **kw)
    for count in range(25):
        want = float(ref(count)) if callable(ref) else ref
        got = ours(count) if callable(ours) else ours
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=str(count))  # optax: fp32


@pytest.mark.parametrize("clip,accum", [(None, 1), (0.05, 1), (None, 2), (0.05, 2)])
def test_adamw_matches_optax(clip, accum):
    """Weight decay masked to ndim >= 2, global-norm clip, MultiSteps accumulation."""
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal((3,)).astype(np.float32)}
    sched = JOPT.make_lr_schedule("onecycle", 1e-2, 6)
    tx_j = JOPT.make_optimizer("adamw", lr=sched, weight_decay=0.1, accum_iter=accum,
                               grad_clip=clip)
    tx_t = TOPT.make_optimizer("adamw", lr=TOPT.make_lr_schedule("onecycle", 1e-2, 6),
                               weight_decay=0.1, accum_iter=accum, grad_clip=clip)
    pj = jax.tree.map(jnp.asarray, params)
    pt = {k: torch.tensor(v) for k, v in params.items()}
    sj, st = tx_j.init(pj), tx_t.init(pt)
    for _ in range(6):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        upd, sj = tx_j.update(jax.tree.map(jnp.asarray, g), sj, pj)
        pj = optax.apply_updates(pj, upd)
        tx_t.update(st, pt, {k: torch.tensor(v) for k, v in g.items()})
        for k in params:
            np.testing.assert_allclose(to_np(pt[k]), np.asarray(pj[k]), atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="not ported"):
        TOPT.make_optimizer("lion")


def test_build_from_stage1_yaml_kwargs():
    kw = {"opt": "adamw", "base_lr": "1e-4", "base_bsz": 64, "weight_decay": "1e-2"}
    tx, peak = TOPT.build(kw, {"sched": "onecycle"}, 200000, 3, 2, 8)
    _, peak_j = JOPT.build(kw, {"sched": "onecycle"}, 200000, 3, 2, 8)
    np.testing.assert_allclose(peak, peak_j, rtol=1e-12)
    assert tx.weight_decay == 1e-2 and tx.accum_iter == 2
    np.testing.assert_allclose(tx._lr(20000), peak, rtol=1e-6)  # the peak at 10 %


def test_remat_gives_the_same_gradients():
    _, ct, _, (ft, tt) = _setup(use_tfa=True, seed=7)
    stage, batch = TS.StageConfig(**STAGES["stage1"][0]), _batch(8)
    noise = TS.draw_noise(ct, {k: torch.from_numpy(v) for k, v in batch.items()},
                          torch.Generator().manual_seed(9))
    loss, _, grads = _port_grads(ft, tt, ct, stage, batch, noise, "ir")
    loss_r, _, grads_r = _port_grads(ft, tt, TS.with_remat(ct), stage, batch, noise, "ir")
    assert loss_r.item() == loss.item()
    for k in grads:
        torch.testing.assert_close(grads_r[k], grads[k], atol=1e-7, rtol=1e-6, msg=k)


def test_remat_recomputes_in_the_backward_pass():
    seen = []

    def unit(x):
        seen.append(TRM.recomputing())
        return torch.sin(x) * x

    x = torch.randn(5, requires_grad=True)
    y = TRM.checkpoint(unit, x)
    assert seen == [False]
    (gx,) = torch.autograd.grad(y.sum(), x)
    assert seen == [False, True] and not TRM.recomputing()
    torch.testing.assert_close(gx, torch.cos(x) * x + torch.sin(x))
    with torch.no_grad():
        TRM.checkpoint(unit, x)
    assert seen == [False, True, False]


def test_checkpoints_cross_read(tmp_path):
    _, ct, (_, tj), (_, tt) = _setup(use_tfa=True, seed=12)
    # JAX writes, the port reads (non-strict into a zero tree)
    jpath = str(tmp_path / "jax.npz")
    JCK.save_checkpoint(jpath, jax.tree.map(jnp.asarray, tj), step=7)
    zeros = bridge.unflatten_like({k: torch.zeros_like(v) for k, v in
                                   bridge.flatten(tt).items()}, tt)
    got, meta = TCK.load_trainable(jpath, zeros)
    assert meta["step"] == 7
    for k, v in bridge.flatten(tt).items():
        torch.testing.assert_close(bridge.flatten(got)[k], v, atol=0, rtol=0, msg=k)
    # stage surgery: only "cfrm" comes from the file
    merged = bridge.flatten(TCK.load_subtree(jpath, zeros, {"cfrm"}))
    for k, v in merged.items():
        assert torch.equal(v, bridge.flatten(tt)[k] if k.startswith("cfrm") else
                           torch.zeros_like(v)), k

    # the port writes, JAX reads
    tx = TOPT.make_optimizer(lr=1e-3)
    stage = TS.StageConfig(**STAGES["stage1"][0])
    state = tx.init(TS.trained_leaves(stage, tt))
    state["count"] = 3
    next(iter(state["mu"].values())).fill_(0.5)
    tpath = str(tmp_path / "port.npz")
    TCK.save_checkpoint(tpath, tt, step=9, opt_state=state, metadata={"stage": 1})
    back, meta = JCK.load_trainable(tpath, jax.tree.map(jnp.zeros_like, tj))
    assert meta["step"] == 9 and meta["stage"] == 1
    for a, b in zip(jax.tree.leaves(tj), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the optimizer state comes back; another structure keeps the fresh state
    restored = TCK.restore_opt_state(tpath, tx.init(TS.trained_leaves(stage, tt)))
    assert restored["count"] == 3
    assert float(next(iter(restored["mu"].values())).min()) == 0.5
    other = tx.init(TS.trained_leaves(TS.StageConfig(**STAGES["stage2_ir"][0]), tt))
    with pytest.warns(UserWarning, match="structure changed"):
        assert TCK.restore_opt_state(tpath, other) is other
