"""Staged training steps (mirrors ``unirestore_tpu/train/steps.py``).

Gradients are taken only with respect to the trainable leaves of the families
a stage trains, and the JAX package's ``stop_gradient`` cuts are ``.detach()``
calls at the same points:

- CFRM gradients flow only through the skip features (the VAE detaches its
  latent path before the last down block).
- The control loss MSE(pred_z0, h0) reaches Controller + SC-Tuner only: the
  conditions l0 carry values, not gradients, into the Controller.
- TFA sees a detached pred_z0 and detached skips.

Loss weights: 0.1/0.1/0.01 on the three CFRM feature MSEs, the control MSE,
and per-task TFA losses 10*L1 ir / 0.1 cls / 0.1 seg (a ``te_loss_fn`` gives
the critic losses), with the auxiliary IR L1 on non-ir multi-task batches.

Randomness is injected: ``StepNoise`` holds the posterior noise of the hq and
lq encodes, the diffusion noise and the timesteps (``draw_noise`` draws them
from a ``torch.Generator``).

The train step (``make_train_step``, the JAX package's split step) takes the
gradients one loss at a time: the CFRM feature loss, the control loss and the
TFA loss each reach one adapter family, so each family's forward and backward
run in turn and free their graph before the next family's forward. Its peak
is the largest part's working set, where one backward of the summed losses
(``compute_losses``, the tests' reference) starts with every part's saved
activations.

Data parallelism (``parallel/``): with a process group the step averages the
trained leaves' gradients over it before the optimizer update, and its logs
are the global means, as the JAX step's are over a sharded batch. Under FSDP
the frozen and trainable trees hold ``Shard`` leaves: the step gathers them
at its start, reduce-scatters the gradients into the shards and updates the
shards.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections.abc import Callable

import torch
import torch.distributed as dist

from .. import bridge
from ..models import unirestore as UR
from ..parallel import fsdp as FSDP
from ..parallel import spatial as SP
from ..parallel.distributed import process_local_rows


@dataclasses.dataclass(frozen=True)
class StageConfig:
    """Which adapter families train (frenc/cnet/tedit "train" flags)."""
    train_cfrm: bool = True
    train_cnet: bool = True
    train_tfa: bool = False
    # stage-3 new-task extension: only prompts train
    tfa_prompts_only: bool = False
    # MTL: auxiliary IR decode loss on non-ir batches
    multi_task: bool = False
    w_fr: tuple = (0.1, 0.1, 0.01)
    w_te: dict = dataclasses.field(
        default_factory=lambda: {"ir": 10.0, "cls": 0.1, "seg": 0.1, "det": 1.0})


@dataclasses.dataclass
class StepNoise:
    """The random draws of one step: posterior noise of the hq and lq encodes
    (the /8 latent moments' shape), diffusion noise (the latents' shape) and
    one timestep per sample."""
    hq: torch.Tensor
    lq: torch.Tensor
    diffusion: torch.Tensor
    timesteps: torch.Tensor


def local_noise(noise: StepNoise, rows: slice) -> StepNoise:
    """This rank's ``rows`` of the noise of a global batch."""
    return StepNoise(noise.hq[rows], noise.lq[rows], noise.diffusion[rows],
                     noise.timesteps[rows])


def draw_noise(cfg: UR.UniRestoreConfig, batch: dict, generator: torch.Generator,
               table: torch.Tensor | None = None, world: int = 1) -> StepNoise:
    """``StepNoise`` for ``batch`` drawn from ``generator`` (timesteps from
    ``TRAIN_TIMESTEPS``; ``table``, if given, is that table already on the
    batch's device, so the draw copies nothing from the host). With ``world``
    ranks, ``batch`` holds this rank's rows of a global batch ``world`` times
    as large: the draws are made at the global shape, the same on every rank,
    and cut to the rank's rows (``process_local_rows``)."""
    hq = batch["hq"]
    b, h, w, _ = hq.shape
    b *= world
    shape = (b, h // 8, w // 8, cfg.vae.latent_channels)

    def normal():
        return torch.randn(shape, generator=generator, device=hq.device, dtype=hq.dtype)

    buf = (torch.tensor(UR.TRAIN_TIMESTEPS, dtype=torch.int32, device=hq.device)
           if table is None else table)
    idx = torch.randint(0, len(buf), (b,), generator=generator, device=hq.device)
    noise = StepNoise(normal(), normal(), normal(), buf[idx])
    return noise if world == 1 else local_noise(noise, process_local_rows(b))


def trainable_filter(stage: StageConfig, trainable):
    """A tree of bools shaped like ``trainable``: which leaves the stage trains."""
    def fill(sub, value):
        return bridge.unflatten_like({k: value for k in bridge.flatten(sub)}, sub)

    families = {"cfrm": stage.train_cfrm, "controller": stage.train_cnet,
                "control": stage.train_cnet, "tfa": stage.train_tfa}
    out = {}
    for name, sub in trainable.items():
        if name == "tfa" and stage.train_tfa and stage.tfa_prompts_only:
            out[name] = {"task_editors": fill(sub["task_editors"], False),
                         "task_prompts": fill(sub["task_prompts"], True)}
        else:
            out[name] = fill(sub, families.get(name, False))
    return out


def trained_leaves(stage: StageConfig, trainable) -> dict:
    """{flat name: tensor} of the leaves ``stage`` trains."""
    mask = bridge.flatten(trainable_filter(stage, trainable))
    return {k: v for k, v in bridge.flatten(trainable).items() if mask[k]}


def _mse(a, b):
    return torch.mean((a.float() - b.float()) ** 2)


def _fr_loss(stage: StageConfig, l0, l0_mids, h0, h0_mids):
    """The weighted CFRM feature loss and its logs (the three skip MSEs, their
    weighted sum and the latent MSE)."""
    fr_terms = [_mse(lm, hm) for lm, hm in zip(l0_mids, h0_mids)]
    loss_fr = sum(w * t for w, t in zip(stage.w_fr, fr_terms))
    logs = {f"train/loss_layer{i + 1}": t for i, t in enumerate(fr_terms)}
    logs["train/loss_frenc"] = loss_fr
    logs["train/loss_enc"] = _mse(l0, h0)
    return loss_fr, logs


def _te_loss(frozen, trainable, cfg: UR.UniRestoreConfig, stage: StageConfig, pred_z0,
             te_mids, batch: dict, task: str, te_loss_fn: Callable | None):
    """The TFA decode of ``task`` and its loss (``te_loss_fn`` or the weighted
    L1), plus the auxiliary ``ir`` decode's L1 on a multi-task batch."""
    hq = batch["hq"]
    preds = UR.decode(frozen, trainable, cfg, pred_z0, te_mids, task)
    if te_loss_fn is not None:
        loss_te = te_loss_fn(preds, hq, batch.get("gt"), task)
    else:
        loss_te = stage.w_te.get(task, 1.0) * torch.mean(torch.abs(preds.float() - hq.float()))
    if stage.multi_task and task != "ir":
        preds_ir = UR.decode(frozen, trainable, cfg, pred_z0, te_mids, "ir")
        loss_te = loss_te + torch.mean(torch.abs(preds_ir.float() - hq.float()))
    return loss_te


def compute_losses(frozen, trainable, cfg: UR.UniRestoreConfig, sched, stage: StageConfig,
                   batch: dict, noise: StepNoise, task: str,
                   te_loss_fn: Callable | None = None):
    """Forward and every stage loss for one batch; returns (total loss, logs).

    ``batch`` has "lq", "hq" (NHWC in [0, 1]) and optionally "gt" (task
    labels); ``te_loss_fn(preds, hq, gt, task)`` is the downstream task loss.
    """
    lq, hq = batch["lq"], batch["hq"]
    logs = {}

    h0, h0_mids = UR.encode(frozen, trainable, cfg, hq, noise=noise.hq, enable_fr=False)
    h0, h0_mids = h0.detach(), [m.detach() for m in h0_mids]
    l0, l0_mids = UR.encode(frozen, trainable, cfg, lq, noise=noise.lq, enable_fr=cfg.use_cfrm)
    if not stage.train_cfrm:
        l0_mids = [m.detach() for m in l0_mids]
    l0 = l0.detach()  # the latent path carries no gradients

    if cfg.use_cnet:
        zt, _, timesteps = UR.diffuse(sched, h0, noise=noise.diffusion,
                                      timesteps=noise.timesteps)
        pred_z0 = UR.predict_z0(frozen, trainable, cfg, sched, zt.detach(), l0, timesteps)
        if not stage.train_cnet:
            pred_z0 = pred_z0.detach()
    else:
        pred_z0 = l0

    loss = torch.zeros((), dtype=torch.float32, device=hq.device)
    if stage.train_cfrm and cfg.use_cfrm:
        loss_fr, fr_logs = _fr_loss(stage, l0, l0_mids, h0, h0_mids)
        loss = loss + loss_fr
        logs.update(fr_logs)

    if stage.train_cnet and cfg.use_cnet:
        loss_cn = _mse(pred_z0, h0)
        loss = loss + loss_cn
        logs["train/loss_cnet"] = loss_cn

    if cfg.use_tfa and stage.train_tfa:
        te_mids = [m.detach() for m in l0_mids] if stage.train_cfrm else l0_mids
        loss_te = _te_loss(frozen, trainable, cfg, stage, pred_z0.detach(), te_mids, batch,
                           task, te_loss_fn)
        loss = loss + loss_te
        logs[f"train/loss_{task}"] = loss_te

    logs["train/loss"] = loss
    return loss, logs


def with_remat(cfg: UR.UniRestoreConfig) -> UR.UniRestoreConfig:
    """``cfg`` with per-unit rematerialisation in the UNet and the VAE."""
    return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, remat=True),
                               vae=dataclasses.replace(cfg.vae, remat=True))


def global_logs(logs: dict, group) -> dict:
    """The mean of each logged scalar over ``group`` (one all-reduce, in
    sorted key order; every rank runs the same task)."""
    keys = sorted(logs)
    vec = torch.stack([logs[k].float() for k in keys])
    dist.all_reduce(vec, op=dist.ReduceOp.SUM, group=group)
    vec.div_(dist.get_world_size(group))
    return dict(zip(keys, vec.unbind()))


def _grads(loss, leaves: dict) -> dict:
    """d ``loss`` / d ``leaves`` by name (None where it does not reach a leaf);
    the graph is freed."""
    return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)))


@contextlib.contextmanager
def _tracking(leaves: dict):
    """Within the block, ``leaves`` require grad and autograd records."""
    for p in leaves.values():
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            yield
    finally:
        for p in leaves.values():
            p.requires_grad_(False)


def _filled(params: dict, grads: dict) -> dict:
    """``grads`` for every leaf of ``params``, zeros where no loss reached one."""
    return {k: torch.zeros_like(p) if grads.get(k) is None else grads[k]
            for k, p in params.items()}


def optimizer_tail(tx, opt_state, like: dict, grads: dict, form: tuple | None = None,
                   group=None) -> torch.Tensor:
    """The optimizer tail's body: one call of ``tx`` on the trained leaves
    ``like`` (tensors or shards) with their mean ``grads``, updating them and
    ``opt_state`` in place; returns ``train/grad_norm``, the global norm of
    ``grads``. Eagerly (``form`` None) the call is ``tx.update``. The graph
    route runs ``tx.advance`` on the host before each replay and passes its
    ``form``, (whether it applies, the per-update scalars as 0-dim tensors of
    a static buffer): the body is then ``tx.apply`` alone, which reads no
    device value on the host, so a CUDA graph holds it
    (``graphs.py:GraphedTrainStep``, one graph a form)."""
    if form is None:
        tx.update(opt_state, like, grads, group)
    else:
        tx.apply(opt_state, like, grads, *form, group)
    return FSDP.global_norm({k: g.float() for k, g in grads.items()}, like, group)


def _apply(stage: StageConfig, tx, group, trainable, opt_state, params: dict, grads: dict,
           logs: dict):
    """The train step's optimizer tail. ``params`` are the whole trained
    leaves and ``grads`` their gradients by name: a leaf no loss reached gets
    zeros (so that every rank runs the same collectives). Then the mean
    gradients and logs over ``group``, and ``optimizer_tail``: the update of
    ``trainable``'s trained leaves (or shards) in place, and
    ``train/grad_norm``."""
    like = trained_leaves(stage, trainable)
    grads = _filled(params, grads)
    logs = {k: v.detach() for k, v in logs.items()}
    if group is not None:
        grads = FSDP.reduce_gradients(grads, like, group)
        logs = global_logs(logs, group)
    logs["train/grad_norm"] = optimizer_tail(tx, opt_state, like, grads, group=group)
    return trainable, opt_state, logs


# the parts of the step, in order, and the adapter family each differentiates
SPLIT_PARTS = ("shared", "fr", "cn", "te")
_FAMILIES = {"fr": ("cfrm",), "cn": ("controller", "control"), "te": ("tfa",)}


def _family(params: dict, part: str) -> dict:
    """The trained leaves of ``part``'s family, by flat name."""
    return {k: p for k, p in params.items() if k.split("//", 1)[0] in _FAMILIES[part]}


def make_step_parts(cfg: UR.UniRestoreConfig, sched, stage: StageConfig, task: str,
                    te_loss_fn: Callable | None = None, stop_after: str | None = None):
    """The parts of the train step (``shared`` -> ``fr`` -> ``cn`` -> ``te``,
    as ``make_train_step`` describes them) as one body that reads only
    tensors:

        parts(frozen, trainable, batch, noise) -> (logs, grads)

    ``frozen`` and ``trainable`` are whole trees (``cfg`` as given: the caller
    turns remat on), ``batch`` and ``noise`` this call's. ``logs`` holds the
    detached losses (``train/loss`` and the terms ``compute_losses`` logs)
    and ``grads`` every trained leaf's gradient by flat name, zeros where no
    part reached one. After a ``stop_after`` part, ``logs`` is only
    ``train/loss``, the loss so far, and ``grads`` is None."""
    if stop_after not in (None, *SPLIT_PARTS):
        raise ValueError(f"stop_after must be one of shared|fr|cn|te, got {stop_after!r}")
    need_fr = stage.train_cfrm and cfg.use_cfrm
    need_cn = stage.train_cnet and cfg.use_cnet
    need_te = cfg.use_tfa and stage.train_tfa

    def parts(frozen, trainable, batch, noise: StepNoise):
        params = trained_leaves(stage, trainable)
        lq, hq = batch["lq"], batch["hq"]
        grads, logs = {}, {}

        with torch.no_grad():
            h0, h0_mids = UR.encode(frozen, trainable, cfg, hq, noise=noise.hq, enable_fr=False)
            if cfg.use_cnet:
                zt, _, timesteps = UR.diffuse(sched, h0, noise=noise.diffusion,
                                              timesteps=noise.timesteps)
        if stop_after == "shared":
            return {"train/loss": h0.mean()}, None

        loss = torch.zeros((), dtype=torch.float32, device=hq.device)
        leaves = _family(params, "fr") if need_fr else {}
        with _tracking(leaves):
            l0, l0_mids = UR.encode(frozen, trainable, cfg, lq, noise=noise.lq,
                                    enable_fr=cfg.use_cfrm)
            l0 = l0.detach()
            te_mids = [m.detach() for m in l0_mids] if need_te else None
            fr = _fr_loss(stage, l0, l0_mids, h0, h0_mids) if need_fr else None
            # the skips are dead past here (the backward holds what it saved)
            del l0_mids, h0_mids
            if fr is not None:
                grads.update(_grads(fr[0], leaves))
                loss = loss + fr[0].detach()
                logs.update({k: v.detach() for k, v in fr[1].items()})
        if stop_after == "fr":
            return {"train/loss": loss}, None

        if cfg.use_cnet:
            leaves = _family(params, "cn") if need_cn else {}
            with _tracking(leaves):
                pred_z0 = UR.predict_z0(frozen, trainable, cfg, sched, zt, l0, timesteps)
                if need_cn:
                    loss_cn = _mse(pred_z0, h0)
                    grads.update(_grads(loss_cn, leaves))
                    loss = loss + loss_cn.detach()
                    logs["train/loss_cnet"] = loss_cn.detach()
            pred_z0 = pred_z0.detach()
        else:
            pred_z0 = l0
        if stop_after == "cn":
            return {"train/loss": loss}, None

        if need_te:
            leaves = _family(params, "te")
            with _tracking(leaves):
                loss_te = _te_loss(frozen, trainable, cfg, stage, pred_z0, te_mids, batch, task,
                                   te_loss_fn)
                grads.update(_grads(loss_te, leaves))
            loss = loss + loss_te.detach()
            logs[f"train/loss_{task}"] = loss_te.detach()
        if stop_after == "te":
            return {"train/loss": loss}, None

        logs["train/loss"] = loss
        return logs, _filled(params, grads)

    return parts


def make_train_step(frozen, cfg: UR.UniRestoreConfig, sched, stage: StageConfig, tx,
                    task: str, te_loss_fn: Callable | None = None, remat: bool = True,
                    group=None, stop_after: str | None = None):
    """The train step for one (stage, task), one loss at a time (the JAX
    package's ``make_split_train_step``, ``unirestore_tpu/train/steps.py:
    224-418``):

        step(trainable, opt_state, batch, noise) -> (trainable, opt_state, logs)

    ``tx`` is a ``train.optim`` optimizer and ``opt_state`` its
    ``tx.init(trained_leaves(stage, trainable))``. The trained leaves are
    updated in place; the other leaves are never touched. ``remat`` turns on
    per-unit rematerialisation (same values, less activation memory).
    ``logs`` holds ``compute_losses``' terms and ``train/grad_norm``, the
    global norm of the trained leaves' gradients (not finite if any is not).
    The step's ``task`` attribute names its task.

    The losses are joined only at ``.detach()`` cuts, and each reaches one
    adapter family, so the step runs them as parts, each a forward and then
    ``torch.autograd.grad`` over its family's trained leaves:

    - ``shared``: the hq encode (no CFRM) and the DDPM noising, without grad;
    - ``fr``: the lq encode with CFRM, gradients of the CFRM feature loss over
      ``cfrm`` (when the stage trains it);
    - ``cn``: ``predict_z0``, gradients of the control loss over ``controller``
      and ``control`` (the SC-Tuner editors or the SPADE blocks);
    - ``te``: the TFA decode of ``task`` (and the auxiliary ``ir`` decode of a
      multi-task batch), gradients of the task loss over ``tfa``'s trained
      leaves (the prompts alone under ``tfa_prompts_only``);
    - then the optimizer tail: zeros for the leaves no part reached, the mean
      over ``group``, the update and ``train/grad_norm``.

    The parts are one body that reads only tensors (``make_step_parts``) and
    the tail another (``optimizer_tail``); ``graphs.py:GraphedTrainStep``
    captures the same two bodies.

    A part hands on only detached tensors and its gradients, so its graph is
    freed before the next part's forward: the activation peak is the largest
    part's, not the sum. Each trained leaf's gradient comes from one loss,
    which the sum of ``compute_losses`` passes 1.0, so one backward of that
    sum gives the same values.

    With a process ``group`` (data parallelism: ``batch`` and ``noise`` are
    this rank's rows), every trained leaf's gradient is averaged over the
    group before the update (zeros too, so every rank runs the same
    collectives), and the losses and the gradient norm logged are the global
    ones. ``frozen`` and ``trainable`` may hold ``parallel.fsdp.Shard``
    leaves (``fsdp_shard``, and ``opt_state`` from ``tx.shard_state``): the
    step then gathers both trees once at its start, reduce-scatters the mean
    gradients into the shards and updates the shards; the full trees are
    freed when it returns. The 2-D mesh is refused.

    ``stop_after`` in ``SPLIT_PARTS`` ends the step after that part: it
    returns ``trainable`` and ``opt_state`` untouched and logs the loss so far
    (after ``shared``, the mean of the hq latents), as the JAX step does.
    """
    cfg = with_remat(cfg) if remat else cfg
    parts = make_step_parts(cfg, sched, stage, task, te_loss_fn, stop_after)

    def step(trainable, opt_state, batch, noise: StepNoise):
        SP.refuse("the train step", "the spatial mesh is for inference (its losses, "
                  "crops and gradients span the image)")
        full_frozen = FSDP.gather_tree(frozen, group)
        full = FSDP.gather_tree(trainable, group)
        logs, grads = parts(full_frozen, full, batch, noise)
        if grads is None:
            return trainable, opt_state, global_logs(logs, group) if group is not None else logs
        return _apply(stage, tx, group, trainable, opt_state, trained_leaves(stage, full), grads,
                      logs)

    step.task = task
    return step


# the JAX package's name for the same step
make_split_train_step = make_train_step
