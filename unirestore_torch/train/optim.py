"""Optimizer and LR schedules (mirrors ``unirestore_tpu/train/optim.py``).

The JAX package builds an optax chain; this module computes the same update
in PyTorch for ``adamw``, the optimizer the stage YAMLs name:

    clip_by_global_norm(grad_clip)      (optional)
    -> scale_by_adam(b1, b2, eps)       (bias-corrected moments)
    -> add_decayed_weights(wd, mask)    (decay only leaves with ndim >= 2)
    -> scale_by_learning_rate(lr)       (lr a constant or a schedule of the step)
    wrapped in MultiSteps(accum_iter)   (running mean of accum_iter gradients,
                                         one update every accum_iter calls)

Schedules: ``onecycle`` (optax ``cosine_onecycle_schedule``) and ``step``
(``exponential_decay(staircase=True)``) give the same values as optax. Other
optimizer names raise.

The state is the port's own: a dict of tensors and counts keyed by leaf name.
``update`` changes the parameters in place (no second copy of the trainable
tree is made).
"""

from __future__ import annotations

import math
from collections.abc import Callable, Mapping

import numpy as np
import torch


def effective_lr(base_lr: float, base_bsz: int, batch_size: int,
                 accum_iter: int, num_devices: int) -> float:
    """base_lr * (effective batch / base_bsz) ** 0.5."""
    eff_bsz = batch_size * accum_iter * num_devices
    return base_lr * (eff_bsz / base_bsz) ** 0.5


def _onecycle(peak_lr: float, total_steps: int, pct_start: float, div_factor: float,
              final_div_factor: float) -> Callable[[int], float]:
    """optax ``cosine_onecycle_schedule``: piecewise cosine between accumulated values."""
    bounds = [0, int(pct_start * total_steps), int(total_steps)]
    values = list(np.cumprod([peak_lr / div_factor, div_factor,
                              1.0 / (div_factor * final_div_factor)]))

    def schedule(count: int) -> float:
        for i in range(2):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return float(end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1))
        return float(values[-1]) if count >= bounds[-1] else 0.0

    return schedule


def make_lr_schedule(sched: str | None, peak_lr: float, total_steps: int, **kwargs):
    """A constant (``sched`` None) or a function of the optimizer step count."""
    if sched is None:
        return peak_lr
    if sched == "onecycle":
        total = max(total_steps, 2)
        # the warmup interval must span at least one step
        pct = max(kwargs.get("pct_start", 0.1), 1.0 / total)
        return _onecycle(peak_lr, total, pct, kwargs.get("div_factor", 10.0),
                         kwargs.get("final_div_factor", 1e4))
    if sched == "step":
        step_size, gamma = kwargs.get("step_size", 30), kwargs.get("gamma", 0.1)
        return lambda count: peak_lr * gamma ** (count // step_size) if count > 0 else peak_lr
    raise ValueError(f"Unknown scheduler: {sched}")


class AdamW:
    """optax ``adamw`` with a weight-decay mask, global-norm clip and MultiSteps."""

    def __init__(self, lr=1e-4, weight_decay: float = 1e-2, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, grad_clip: float | None = None,
                 accum_iter: int = 1):
        self.lr, self.weight_decay = lr, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.grad_clip, self.accum_iter = grad_clip, accum_iter

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        """Zero moments (and gradient accumulators) for the named leaves."""
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}  # noqa: E731
        state = {"count": 0, "mu": zeros(), "nu": zeros(), "mini_step": 0}
        if self.accum_iter > 1:
            state["acc"] = zeros()
        return state

    def _lr(self, count: int) -> float:
        return self.lr(count) if callable(self.lr) else self.lr

    @torch.no_grad()
    def update(self, state: dict, params: Mapping[str, torch.Tensor],
               grads: Mapping[str, torch.Tensor]) -> bool:
        """Apply one call's gradients; returns whether the parameters changed."""
        names = list(params)
        g = [grads[k] for k in names]
        if self.accum_iter > 1:
            acc = [state["acc"][k] for k in names]
            n = state["mini_step"]
            for a, gi in zip(acc, g):  # running mean (optax MultiSteps, Welford)
                a.add_((gi - a) / (n + 1))
            if n < self.accum_iter - 1:
                state["mini_step"] = n + 1
                return False
            state["mini_step"] = 0
            g = [a.clone() for a in acc]
            for a in acc:
                a.zero_()
        if self.grad_clip is not None:
            norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(x) for x in g]))
            if not norm < self.grad_clip:
                g = [x / norm * self.grad_clip for x in g]
        lr = self._lr(state["count"])
        state["count"] += 1
        c = state["count"]
        bc1, bc2 = 1 - self.b1 ** c, 1 - self.b2 ** c
        for k, gi in zip(names, g):
            p, mu, nu = params[k], state["mu"][k], state["nu"][k]
            mu.mul_(self.b1).add_(gi, alpha=1 - self.b1)
            nu.mul_(self.b2).addcmul_(gi, gi, value=1 - self.b2)
            upd = (mu / bc1) / ((nu / bc2).sqrt() + self.eps)
            if self.weight_decay and p.ndim >= 2:  # timm mask: no decay on 1-D leaves
                upd.add_(p, alpha=self.weight_decay)
            p.add_(upd, alpha=-lr)
        return True


def make_optimizer(opt: str = "adamw", lr=1e-4, weight_decay: float = 1e-2,
                   accum_iter: int = 1, grad_clip: float | None = None) -> AdamW:
    """``adamw`` only; the JAX package's other names are not ported yet."""
    if opt.lower() != "adamw":
        raise ValueError(f"optimizer {opt!r} is not ported (supported: ['adamw'])")
    return AdamW(lr, weight_decay, grad_clip=grad_clip, accum_iter=accum_iter)


def build(optimizer_kwargs: dict, lr_scheduler_kwargs: dict | None, total_steps: int,
          batch_size: int, accum_iter: int, num_devices: int):
    """(optimizer, peak lr) from the YAML kwargs surface (train_stage1.yaml:33-39)."""
    # YAML 1.1 reads "1e-4" as a string: coerce numeric fields
    def num(v):
        if isinstance(v, str):
            try:
                return float(v)
            except ValueError:
                return v
        return v

    optimizer_kwargs = {k: num(v) for k, v in optimizer_kwargs.items()}
    peak = effective_lr(float(optimizer_kwargs["base_lr"]), int(optimizer_kwargs["base_bsz"]),
                        batch_size, accum_iter, num_devices)
    sched_kwargs = dict(lr_scheduler_kwargs or {})
    sched = sched_kwargs.pop("sched", None)
    lr = make_lr_schedule(sched, peak, total_steps, **sched_kwargs)
    return make_optimizer(opt=optimizer_kwargs.get("opt", "adamw"), lr=lr,
                          weight_decay=optimizer_kwargs.get("weight_decay", 0.0),
                          accum_iter=accum_iter,
                          grad_clip=optimizer_kwargs.get("grad_clip")), peak
