"""DDPM/DDIM scheduler math over an alphas-cumprod table.

Mirrors ``unirestore_tpu/diffusion/schedules.py``: the sd-turbo scheduler
(1000 train timesteps, scaled_linear betas [0.00085, 0.012], epsilon
prediction, trailing spacing, ``set_alpha_to_one=False``). Scheduler math runs
in fp32 whatever the latent dtype. The DDIM loop calls ``ddim_step`` with a
Python int timestep.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    alphas_cumprod: torch.Tensor  # (T,) fp32
    final_alpha_cumprod: torch.Tensor  # scalar, alpha_bar for "step -1"
    num_train_timesteps: int

    def to(self, device) -> "DiffusionSchedule":
        return dataclasses.replace(self, alphas_cumprod=self.alphas_cumprod.to(device),
                                   final_alpha_cumprod=self.final_alpha_cumprod.to(device))


def make_schedule(num_train_timesteps: int = 1000, beta_start: float = 0.00085,
                  beta_end: float = 0.012, device="cpu") -> DiffusionSchedule:
    """The scaled-linear schedule; ``final_alpha_cumprod`` is alpha_bar[0]."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                        num_train_timesteps, dtype=np.float64) ** 2
    acp = np.cumprod(1.0 - betas).astype(np.float32)
    return DiffusionSchedule(
        alphas_cumprod=torch.from_numpy(acp).to(device),
        final_alpha_cumprod=torch.tensor(acp[0], dtype=torch.float32, device=device),
        num_train_timesteps=num_train_timesteps,
    )


def _per_sample(sched, timesteps, ndim):
    a = sched.alphas_cumprod[timesteps.long()]
    return a.reshape((-1,) + (1,) * (ndim - 1))


def add_noise(sched: DiffusionSchedule, x0, noise, timesteps):
    """DDPM forward noising: sqrt(a_t) x0 + sqrt(1-a_t) n, with a_t in x0's dtype."""
    a = _per_sample(sched, timesteps, x0.ndim).to(x0.dtype)
    return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise


def predict_x0_from_eps(sched: DiffusionSchedule, zt, eps, timesteps):
    """x0 = (z_t - sqrt(1-a_t) eps) / sqrt(a_t), in fp32."""
    a = _per_sample(sched, timesteps, zt.ndim).float()
    x0 = (zt.float() - torch.sqrt(1.0 - a) * eps.float()) / torch.sqrt(a)
    return x0.to(zt.dtype)


def ddim_timesteps(num_inference_steps: int, num_train_timesteps: int = 1000) -> np.ndarray:
    """Static inference timestep table (descending), diffusers' trailing spacing."""
    n, big_t = num_inference_steps, num_train_timesteps
    ts = np.round(np.arange(big_t, 0, -big_t / n)).astype(np.int64) - 1
    return ts.astype(np.int32)


def ddim_step(sched: DiffusionSchedule, zt, eps, t: int, num_inference_steps: int):
    """One deterministic (eta=0) DDIM update from timestep ``t``.

    ``t - step < 0`` takes ``final_alpha_cumprod`` (set_alpha_to_one=False).
    """
    t = int(t)
    prev_t = t - sched.num_train_timesteps // num_inference_steps
    a_t = sched.alphas_cumprod[t]
    a_prev = sched.alphas_cumprod[prev_t] if prev_t >= 0 else sched.final_alpha_cumprod
    zt32, eps32 = zt.float(), eps.float()
    x0 = (zt32 - torch.sqrt(1.0 - a_t) * eps32) / torch.sqrt(a_t)
    z_prev = torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps32
    return z_prev.to(zt.dtype)
