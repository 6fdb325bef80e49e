"""Optimizers and LR schedules (mirrors ``unirestore_tpu/train/optim.py``).

The JAX package builds an optax chain per name (``make_optimizer``,
``unirestore_tpu/train/optim.py:53-118``); this module computes the same
updates in PyTorch, after optax 0.2.6's update rules and defaults (not
``torch.optim``'s), for every name it accepts:

- decoupled weight decay (masked to leaves with ndim >= 2, timm's rule):
  ``adamw``, ``nadamw``, ``radam``, ``lamb``, ``lion``, ``lars``, ``sgdw``;
  ``adafactor`` with its own unmasked decay, added after the learning rate;
- coupled (L2) decay, masked, added to the gradient first (timm's non-``w``
  forms): ``adam``, ``nadam``, ``adamax``, ``sgd`` (Nesterov), ``momentum``,
  ``rmsprop``, ``adagrad``, ``adadelta``.

Every optimizer shares ``Optimizer``'s part of the chain:

    MultiSteps(accum_iter)              (running mean of accum_iter gradients,
                                         one update every accum_iter calls)
    -> clip_by_global_norm(grad_clip)   (optional)
    -> the rule of the name             (``Optimizer.delta``), whose learning
                                         rate is a constant or a schedule of
                                         the update count

Schedules: ``onecycle`` (optax ``cosine_onecycle_schedule``) and ``step``
(``exponential_decay(staircase=True)``) give the same values as optax.

The state is the port's own: a flat dict of tensors and counts keyed by leaf
name (``count``, the rule's per-leaf slots, ``mini_step``, and ``acc`` under
accumulation), which ``train/checkpoints.py`` saves and restores. ``update``
changes the parameters in place (no second copy of the trainable tree is
made). Decay rates raised to the update count are taken in fp32 by repeated
squaring, as XLA computes optax's ``decay ** count``.

``update`` is two halves. ``advance`` is the host's: it moves ``mini_step``
and ``count`` (host integers, as checkpoints save them) and returns whether
the call applies an update and the call's per-update scalars (the
accumulation divisor, the learning rate and the rule's own: Adam's
bias-correction divisors, RAdam's rectification, Adafactor's decay rate)
as host floats. ``apply`` is the device's: it reads the scalars either as
those floats or as 0-dim fp32 tensors on the device (``graphs.py:
GraphedTrainStep`` copies them into a static buffer before each replay),
with the same values: a tensor divisor is applied as PyTorch applies a host
one (``_divide``), a branch on a scalar becomes a ``torch.where``, and the
global-norm clip is a ``torch.where`` between the gradient and its scaled
form in both, so nothing in ``apply`` reads a device value on the host.

Under FSDP (``parallel/fsdp.py``) a parameter may be a ``Shard``, this rank's
block of the leaf, and its slots are then ``Shard``s of theirs
(``Optimizer.shard_state``). Elementwise rules update a block as they would
the whole leaf; the four places that read a whole leaf or the whole tree
take their sums over the process group: the global-norm clip, the trust
ratio of ``lamb`` and ``lars``, ``adafactor``'s block RMS and its factored
moments' means along the sharded axis (whose factoring follows the full
shape).
"""

from __future__ import annotations

import math
from collections.abc import Callable, Mapping

import numpy as np
import torch

from ..parallel.fsdp import Shard, global_norm, group_sum, leaf_norms, shard_tensor


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


def _pow32(x: float, n: int) -> np.float32:
    """``x ** n`` in fp32 by repeated squaring (XLA's power with an integer exponent)."""
    x, out = np.float32(x), np.float32(1.0)
    while n:
        if n & 1:
            out = np.float32(out * x)
        x, n = np.float32(x * x), n >> 1
    return out


def _debias(decay: float, count: int) -> float:
    """optax ``bias_correction``'s divisor 1 - decay ** count, in fp32."""
    return float(np.float32(1.0) - _pow32(decay, count))


def _divisor(name: str, d: float) -> dict:
    """The per-update divisor ``name`` and, as ``name + "_inv"``, its fp32 reciprocal."""
    return {name: float(d), f"{name}_inv": float(np.float32(1.0) / np.float32(d))}


def _divide(x, s: dict, name: str):
    """``x`` over the per-update divisor ``s[name]``. PyTorch divides a CUDA
    tensor by a host scalar as a product with the scalar's fp32 reciprocal,
    and a CPU tensor by true division; a 0-dim tensor divisor takes the same
    arithmetic on either device, so results are bit-equal to the host form."""
    d = s[name]
    if isinstance(d, torch.Tensor) and x.is_cuda:
        return x * s[f"{name}_inv"]
    return x / d


def _add_scaled(x, y, c):
    """``x += c * y`` in place, ``c`` a host float or a 0-dim tensor."""
    if isinstance(c, torch.Tensor):
        return x.addcmul_(y, c)
    return x.add_(y, alpha=c)


class Optimizer:
    """The part every optimizer shares: the state, ``MultiSteps`` accumulation
    (a running mean, one update every ``accum_iter`` calls), global-norm
    clipping, the learning rate (a constant or a schedule of the update count),
    and coupled L2 decay (``coupled``: ``weight_decay * p`` added to the clipped
    gradient of every leaf with ndim >= 2). A rule names its per-leaf ``slots``
    and computes each leaf's change in ``delta``.

    While ``update`` runs, ``_shards`` holds the ``Shard`` of each sharded
    parameter and ``_group`` the process group its sums run over."""

    slots: tuple = ()
    _shards: dict = {}
    _group = None

    def __init__(self, lr=1e-4, weight_decay: float = 0.0, grad_clip: float | None = None,
                 accum_iter: int = 1, coupled: bool = False):
        self.lr, self.weight_decay = lr, weight_decay
        self.grad_clip, self.accum_iter, self.coupled = grad_clip, accum_iter, coupled

    def slot_init(self, name: str, p: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(p)

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        """The rule's slots (and gradient accumulators) for the named leaves."""
        state = {"count": 0}
        for name in self.slots:
            state[name] = {k: self.slot_init(name, p) for k, p in params.items()}
        state["mini_step"] = 0
        if self.accum_iter > 1:
            state["acc"] = {k: torch.zeros_like(p) for k, p in params.items()}
        return state

    def _lr(self, count: int) -> float:
        return self.lr(count) if callable(self.lr) else self.lr

    def _decay(self, p) -> float:
        """The masked decay rate of a leaf: none on 1-D leaves (timm's rule)."""
        return self.weight_decay if self.weight_decay and p.ndim >= 2 else 0.0

    def scalars(self, t: int, lr: float) -> dict:
        """The per-update scalars ``delta`` reads at update ``t`` (1-based) with
        learning rate ``lr``, as host floats (the same keys at every ``t``)."""
        return {"lr": lr}

    def delta(self, state: dict, k: str, p, g, s: dict):
        """The change of leaf ``k``, updating its slots; ``s`` holds the
        update's ``scalars`` as host floats or 0-dim tensors."""
        raise NotImplementedError

    def slot_axis(self, name: str, shape: tuple, axis: int):
        """The axis along which slot ``name`` of a leaf of full ``shape``
        sharded along ``axis`` is sharded with it; None: the slot is whole."""
        return axis

    def shard_state(self, state: dict, params: Mapping, rank: int) -> dict:
        """``state`` (built for the full leaves) with each slot of a parameter
        that ``params`` holds as a ``Shard`` cut to this rank's block of it."""
        out = dict(state)
        for name, sub in state.items():
            if not isinstance(sub, dict):
                continue
            out[name] = dict(sub)
            for k, t in sub.items():
                p = params[k]
                axis = self.slot_axis(name, p.shape, p.axis) if isinstance(p, Shard) else None
                if axis is not None:
                    out[name][k] = shard_tensor(t, axis, p.parts, rank)
        return out

    def _norm(self, k: str, x):
        """The 2-norm of the whole leaf ``k`` of which ``x`` is this rank's part."""
        if k in self._shards:
            return leaf_norms({k: x}, self._shards, self._group)[k]
        return torch.linalg.vector_norm(x)

    def _trust_ratio(self, k: str, p, u, coefficient: float = 1.0):
        """optax ``scale_by_trust_ratio``: coefficient * |p| / |u|, 1 where a norm is 0."""
        pn, un = self._norm(k, p), self._norm(k, u)
        ratio = coefficient * pn / un
        return torch.where((pn == 0) | (un == 0), torch.ones_like(ratio), ratio)

    def _rms(self, k: str, x):
        if k in self._shards:
            return self._norm(k, x) / math.sqrt(self._shards[k].numel)
        return x.square().mean().sqrt()

    def update(self, state: dict, params: Mapping, grads: Mapping[str, torch.Tensor],
               group=None) -> bool:
        """Apply one call's gradients; returns whether the parameters changed.
        A parameter given as a ``Shard`` is updated in its block, with
        ``grads`` holding the block's gradient and whole-leaf sums taken over
        ``group``."""
        applies, s = self.advance(state)
        self.apply(state, params, grads, applies, s, group)
        return applies

    def advance(self, state: dict) -> tuple[bool, dict]:
        """The host half of one call: moves ``mini_step`` and ``count`` on as
        the call does and returns (whether it applies an update, its per-update
        scalars as host floats: ``acc`` and ``acc_inv``, the accumulation
        divisor, under accumulation; ``scalars(count, lr)`` when it applies).
        Reads nothing but the two counts."""
        s = {}
        if self.accum_iter > 1:
            n = state["mini_step"]
            s.update(_divisor("acc", n + 1))
            if n < self.accum_iter - 1:
                state["mini_step"] = n + 1
                return False, s
            state["mini_step"] = 0
        lr = self._lr(state["count"])
        state["count"] += 1
        return True, {**s, **self.scalars(state["count"], lr)}

    @torch.no_grad()
    def apply(self, state: dict, params: Mapping, grads: Mapping[str, torch.Tensor],
              applies: bool, s: dict, group=None) -> None:
        """The device half of one call, after ``advance`` gave ``applies`` and
        the scalars ``s`` (host floats, or 0-dim tensors holding their values):
        the running mean of the gradients under accumulation and, when the
        call applies, the clip and each leaf's change. Syncs nothing."""
        self._shards = {k: p for k, p in params.items() if isinstance(p, Shard)}
        self._group = group
        try:
            self._apply({k: getattr(p, "local", p) for k, p in params.items()}, state, grads,
                        applies, s)
        finally:
            self._shards, self._group = {}, None

    def _apply(self, params: Mapping[str, torch.Tensor], state: dict,
               grads: Mapping[str, torch.Tensor], applies: bool, s: dict) -> None:
        # the slots' blocks where they are sharded; the counts stay in ``state``
        slots = {name: {k: getattr(v, "local", v) for k, v in sub.items()}
                 for name, sub in state.items() if isinstance(sub, dict)}
        names = list(params)
        g = [grads[k] for k in names]
        if self.accum_iter > 1:
            acc = [slots["acc"][k] for k in names]
            for a, gi in zip(acc, g):  # running mean (optax MultiSteps, Welford)
                a.add_(_divide(gi - a, s, "acc"))
            if not applies:
                return
            g = [a.clone() for a in acc]
            for a in acc:
                a.zero_()
        if self.grad_clip is not None:
            # the clip's branch as a select: the same values (a NaN norm
            # scales, as ``not norm < clip`` did), no host read of the norm
            norm = global_norm(dict(zip(names, g)), self._shards, self._group)
            keep = norm < self.grad_clip
            g = [torch.where(keep, x, x / norm * self.grad_clip) for x in g]
        for k, gi in zip(names, g):
            p = params[k]
            if self.coupled and self._decay(p):
                gi = gi + self._decay(p) * p
            p.add_(self.delta(slots, k, p, gi, s))


class Adam(Optimizer):
    """optax ``scale_by_adam`` (``nesterov``: NAdam's first moment), then the
    masked decoupled decay unless ``coupled``, then -lr."""

    slots = ("mu", "nu")

    def __init__(self, lr=1e-4, weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, grad_clip: float | None = None, accum_iter: int = 1,
                 nesterov: bool = False, coupled: bool = False):
        super().__init__(lr, weight_decay, grad_clip, accum_iter, coupled)
        self.b1, self.b2, self.eps, self.nesterov = b1, b2, eps, nesterov

    def scalars(self, t, lr):
        """The bias-correction divisors of update ``t`` (``d1``, ``d2``; Nesterov
        also ``d1_next``, the first moment's at ``t + 1``)."""
        s = {"lr": lr, **_divisor("d1", _debias(self.b1, t)),
             **_divisor("d2", _debias(self.b2, t))}
        if self.nesterov:
            s.update(_divisor("d1_next", _debias(self.b1, t + 1)))
        return s

    def normalized(self, state, k, g, s):
        """(bias-corrected first moment, bias-corrected second moment)."""
        mu, nu = state["mu"][k], state["nu"][k]
        mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
        nu.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
        if self.nesterov:
            mu_hat = (self.b1 * _divide(mu, s, "d1_next")
                      + (1 - self.b1) * _divide(g, s, "d1"))
        else:
            mu_hat = _divide(mu, s, "d1")
        return mu_hat, _divide(nu, s, "d2")

    def direction(self, state, k, p, g, s):
        mu_hat, nu_hat = self.normalized(state, k, g, s)
        upd = mu_hat / (nu_hat.sqrt() + self.eps)
        if not self.coupled and self._decay(p):
            upd.add_(p, alpha=self._decay(p))
        return upd

    def delta(self, state, k, p, g, s):
        return -s["lr"] * self.direction(state, k, p, g, s)


class AdamW(Adam):
    """optax ``adamw`` (b1 0.9, b2 0.999, eps 1e-8) with the ndim >= 2 decay mask."""

    def __init__(self, lr=1e-4, weight_decay: float = 1e-2, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, grad_clip: float | None = None, accum_iter: int = 1):
        super().__init__(lr, weight_decay, b1, b2, eps, grad_clip, accum_iter)


class RAdam(Adam):
    """optax ``scale_by_radam`` (threshold 5; below it the bias-corrected first
    moment alone), then the masked decay after the moment normaliser, then -lr."""

    threshold = 5.0

    def scalars(self, t, lr):
        """Adam's, and ``rect`` (whether update ``t`` rectifies) with its factor ``r``."""
        s = super().scalars(t, lr)
        ro_inf = np.float32(2.0 / (1.0 - self.b2) - 1.0)
        b2t = _pow32(self.b2, t)
        ro = np.float32(ro_inf - np.float32(2 * t) * b2t / (np.float32(1.0) - b2t))
        rect = bool(ro >= self.threshold)
        r = np.sqrt(np.float32((ro - 4.0) * (ro - 2.0) * ro_inf)
                    / np.float32((ro_inf - 4.0) * (ro_inf - 2.0) * ro)) if rect else 0.0
        return {**s, "rect": rect, "r": float(r)}

    def direction(self, state, k, p, g, s):
        mu_hat, nu_hat = self.normalized(state, k, g, s)
        rect = s["rect"]
        if isinstance(rect, torch.Tensor):
            upd = torch.where(rect > 0, s["r"] * mu_hat / (nu_hat.sqrt() + self.eps), mu_hat)
        elif rect:
            upd = s["r"] * mu_hat / (nu_hat.sqrt() + self.eps)
        else:
            upd = mu_hat
        if self._decay(p):
            upd = upd + self._decay(p) * p
        return upd


class Lamb(Adam):
    """optax ``lamb``: ``scale_by_adam`` (eps 1e-6), the masked decay, the
    trust ratio |p| / |update| (1 where a norm is 0), then -lr."""

    def direction(self, state, k, p, g, s):
        upd = super().direction(state, k, p, g, s)
        return upd * self._trust_ratio(k, p, upd)


class Adamax(Optimizer):
    """optax ``scale_by_adamax``: the bias-corrected first moment over the
    infinity norm max(|g| + eps, b2 * nu); then -lr."""

    slots = ("mu", "nu")

    def __init__(self, lr=1e-4, weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, **kw):
        super().__init__(lr, weight_decay, **kw)
        self.b1, self.b2, self.eps = b1, b2, eps

    def scalars(self, t, lr):
        return {"lr": lr, **_divisor("d1", _debias(self.b1, t))}

    def delta(self, state, k, p, g, s):
        mu, nu = state["mu"][k], state["nu"][k]
        mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
        torch.maximum(g.abs() + self.eps, self.b2 * nu, out=nu)
        return -s["lr"] * (_divide(mu, s, "d1") / nu)


class Lion(Optimizer):
    """optax ``lion`` (b1 0.9, b2 0.99): sign((1 - b1) g + b1 mu), the moment
    mu <- (1 - b2) g + b2 mu, the masked decay, then -lr."""

    slots = ("mu",)

    def __init__(self, lr=1e-4, weight_decay: float = 1e-3, b1: float = 0.9, b2: float = 0.99,
                 **kw):
        super().__init__(lr, weight_decay, **kw)
        self.b1, self.b2 = b1, b2

    def delta(self, state, k, p, g, s):
        mu = state["mu"][k]
        upd = torch.sign((1 - self.b1) * g + self.b1 * mu)
        mu.mul_(self.b2).add_(g, alpha=1 - self.b2)
        if self._decay(p):
            upd = upd + self._decay(p) * p
        return -s["lr"] * upd


class Trace(Optimizer):
    """optax ``trace`` (momentum; Nesterov: g + m * (g + m * trace)) with -lr:
    ``sgd`` (coupled, Nesterov), ``momentum`` (coupled), ``sgdw`` (Nesterov,
    then the masked decoupled decay)."""

    slots = ("trace",)

    def __init__(self, lr=1e-4, weight_decay: float = 0.0, momentum: float = 0.9,
                 nesterov: bool = False, **kw):
        super().__init__(lr, weight_decay, **kw)
        self.momentum, self.nesterov = momentum, nesterov

    def traced(self, state, k, u):
        tr = state["trace"][k]
        tr.mul_(self.momentum).add_(u)
        return u + self.momentum * tr if self.nesterov else tr.clone()

    def delta(self, state, k, p, g, s):
        upd = self.traced(state, k, g)
        if not self.coupled and self._decay(p):
            upd = upd + self._decay(p) * p
        return -s["lr"] * upd


class Lars(Trace):
    """optax ``lars``: the masked decay, the trust ratio 0.001 * |p| / |g| (1
    where a norm is 0), -lr, then the (non-Nesterov) trace of the scaled update."""

    trust_coefficient = 0.001

    def delta(self, state, k, p, g, s):
        upd = g + self._decay(p) * p if self._decay(p) else g
        upd = upd * self._trust_ratio(k, p, upd, self.trust_coefficient)
        return self.traced(state, k, -s["lr"] * upd)


class RMSprop(Trace):
    """optax ``rmsprop`` (decay 0.9, eps 1e-8 inside the root, no centring):
    g / sqrt(nu + eps), -lr, then the trace with ``momentum``."""

    slots = ("nu", "trace")

    def __init__(self, lr=1e-4, weight_decay: float = 0.0, momentum: float = 0.9,
                 decay: float = 0.9, eps: float = 1e-8, **kw):
        super().__init__(lr, weight_decay, momentum, **kw)
        self.decay, self.eps = decay, eps

    def delta(self, state, k, p, g, s):
        nu = state["nu"][k]
        nu.mul_(self.decay).addcmul_(g, g, value=1 - self.decay)
        return self.traced(state, k, -s["lr"] * (g * torch.rsqrt(nu + self.eps)))


class Adagrad(Optimizer):
    """optax ``adagrad``: the sum of squares from 0.1, g / sqrt(sum + 1e-7), -lr."""

    slots = ("sum_of_squares",)

    def __init__(self, lr=1e-4, weight_decay: float = 0.0, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7, **kw):
        super().__init__(lr, weight_decay, **kw)
        self.initial, self.eps = initial_accumulator_value, eps

    def slot_init(self, name, p):
        return torch.full_like(p, self.initial)

    def delta(self, state, k, p, g, s):
        sos = state["sum_of_squares"][k]
        sos.addcmul_(g, g)
        inv = torch.where(sos > 0, torch.rsqrt(sos + self.eps), torch.zeros_like(sos))
        return -s["lr"] * (inv * g)


class Adadelta(Optimizer):
    """optax ``adadelta`` (rho 0.9, eps 1e-6): sqrt(E[dx^2] + eps) /
    sqrt(E[g^2] + eps) * g, then E[dx^2] from that update; -lr."""

    slots = ("e_g", "e_x")

    def __init__(self, lr=1e-4, weight_decay: float = 0.0, rho: float = 0.9, eps: float = 1e-6,
                 **kw):
        super().__init__(lr, weight_decay, **kw)
        self.rho, self.eps = rho, eps

    def delta(self, state, k, p, g, s):
        e_g, e_x = state["e_g"][k], state["e_x"][k]
        e_g.mul_(self.rho).addcmul_(g, g, value=1 - self.rho)
        upd = (e_x + self.eps).sqrt() / (e_g + self.eps).sqrt() * g
        e_x.mul_(self.rho).addcmul_(upd, upd, value=1 - self.rho)
        return -s["lr"] * upd


def _factored_dims(shape, min_dim_size_to_factor: int = 128):
    """optax adafactor's rule: (second largest, largest) axes when both are
    at least ``min_dim_size_to_factor``, else None (moments kept whole)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape, kind="stable")
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(Optimizer):
    """optax ``adafactor`` with its defaults: factored second moments where the
    two largest axes are both >= 128 (``scale_by_factored_rms``: decay
    1 - (step + 1) ** -0.8, eps 1e-30), ``clip_by_block_rms(1.0)``, lr,
    ``scale_by_param_block_rms`` (max(rms(p), 1e-3)), then the UNMASKED decay
    ``weight_decay * p`` after the learning rate: a step with zero gradients
    moves a leaf by ``weight_decay * p``."""

    slots = ("v_row", "v_col", "v")
    decay_rate, eps, clip, min_scale = 0.8, 1e-30, 1.0, 1e-3

    def slot_init(self, name, p):
        dims = _factored_dims(tuple(p.shape))
        if dims is None:
            return torch.zeros_like(p) if name == "v" else p.new_zeros((1,))
        d1, d0 = dims
        if name == "v_row":
            return p.new_zeros(tuple(np.delete(p.shape, d0)))
        if name == "v_col":
            return p.new_zeros(tuple(np.delete(p.shape, d1)))
        return p.new_zeros((1,))

    def slot_axis(self, name, shape, axis):
        if name not in self.slots:  # the gradient accumulator
            return axis
        dims = _factored_dims(tuple(shape))
        if dims is None:
            return axis if name == "v" else None
        d1, d0 = dims
        cut = {"v_row": d0, "v_col": d1}.get(name)
        return None if cut is None or cut == axis else axis - (axis > cut)

    def _mean(self, k, x, dim: int, axis, keepdim: bool = False):
        """The mean of ``x`` over ``dim`` of the whole leaf ``k``: over the group
        where ``dim`` is ``x``'s sharded ``axis``."""
        if k not in self._shards or dim != axis:
            return x.mean(dim=dim, keepdim=keepdim)
        return group_sum(x.sum(dim=dim, keepdim=keepdim), self._group) / (
            x.shape[dim] * self._shards[k].parts)

    def scalars(self, t, lr):
        """The moments' decay ``rate`` of update ``t`` and ``rate_c``, 1 - rate."""
        rate = float(np.float32(1.0) - np.float32(t) ** np.float32(-self.decay_rate))
        return {"lr": lr, "rate": rate, "rate_c": 1 - rate}

    def delta(self, state, k, p, g, s):
        rate, rate_c = s["rate"], s["rate_c"]
        g2 = g * g + self.eps
        shape = self._shards[k].shape if k in self._shards else tuple(p.shape)
        axis = self._shards[k].axis if k in self._shards else None
        dims = _factored_dims(shape)
        if dims is None:
            v = state["v"][k]
            _add_scaled(v.mul_(rate), g2, rate_c)
            upd = g * v.rsqrt()
        else:
            d1, d0 = dims
            v_row, v_col = state["v_row"][k], state["v_col"][k]
            _add_scaled(v_row.mul_(rate), self._mean(k, g2, d0, axis), rate_c)
            _add_scaled(v_col.mul_(rate), self._mean(k, g2, d1, axis), rate_c)
            row_axis = self.slot_axis("v_row", shape, axis) if axis is not None else None
            row = (v_row / self._mean(k, v_row, d1 - 1 if d1 > d0 else d1, row_axis,
                                      keepdim=True)).rsqrt()
            upd = g * row.unsqueeze(d0) * v_col.rsqrt().unsqueeze(d1)
        upd = upd / torch.clamp(self._rms(k, upd) / self.clip, min=1.0)
        upd = s["lr"] * upd
        upd = upd * torch.clamp(self._rms(k, p), min=self.min_scale)
        if self.weight_decay:
            upd = upd + self.weight_decay * p
        return -upd


def make_optimizer(opt: str = "adamw", lr=1e-4, weight_decay: float = 1e-2,
                   momentum: float = 0.9, accum_iter: int = 1,
                   grad_clip: float | None = None) -> Optimizer:
    """The optimizer of an ``optimizer_kwargs.opt`` name (timm's
    ``create_optimizer_v2`` surface, as the JAX ``make_optimizer``)."""
    kw = dict(grad_clip=grad_clip, accum_iter=accum_iter)
    decoupled = {
        "adamw": lambda: AdamW(lr, weight_decay, **kw),
        "nadamw": lambda: Adam(lr, weight_decay, nesterov=True, **kw),
        "radam": lambda: RAdam(lr, weight_decay, **kw),
        "lamb": lambda: Lamb(lr, weight_decay, eps=1e-6, **kw),
        "lion": lambda: Lion(lr, weight_decay, **kw),
        "adafactor": lambda: Adafactor(lr, weight_decay, **kw),
        "lars": lambda: Lars(lr, weight_decay, momentum=momentum, **kw),
        "sgdw": lambda: Trace(lr, weight_decay, momentum=momentum, nesterov=True, **kw),
    }
    coupled = {  # timm's non-*w forms: L2 decay inside the gradient
        "adam": lambda: Adam(lr, weight_decay, coupled=True, **kw),
        "nadam": lambda: Adam(lr, weight_decay, nesterov=True, coupled=True, **kw),
        "adamax": lambda: Adamax(lr, weight_decay, coupled=True, **kw),
        "sgd": lambda: Trace(lr, weight_decay, momentum=momentum, nesterov=True, coupled=True,
                             **kw),
        "momentum": lambda: Trace(lr, weight_decay, momentum=momentum, coupled=True, **kw),
        "rmsprop": lambda: RMSprop(lr, weight_decay, momentum=momentum, coupled=True, **kw),
        "adagrad": lambda: Adagrad(lr, weight_decay, coupled=True, **kw),
        "adadelta": lambda: Adadelta(lr, weight_decay, coupled=True, **kw),
    }
    name = opt.lower()
    if name in decoupled:
        return decoupled[name]()
    if name in coupled:
        return coupled[name]()
    raise ValueError(f"Unknown optimizer: {opt!r} (supported: "
                     f"{sorted(decoupled) + sorted(coupled)})")


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
                          momentum=optimizer_kwargs.get("momentum", 0.9),
                          accum_iter=accum_iter,
                          grad_clip=optimizer_kwargs.get("grad_clip")), peak
