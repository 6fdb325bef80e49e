"""Weight initializers with PyTorch's layer-default bounds.

Mirrors ``unirestore_tpu/nn/init.py``: kaiming-uniform (a = sqrt(5)) for conv
and linear kernels, uniform(+-1/sqrt(fan_in)) for biases. Draws come from an
explicit ``torch.Generator`` on the target device; JAX's draws cannot be
reproduced, so parity tests convert JAX-initialised params with ``bridge``
instead. On the ``meta`` device only shapes are made (used to describe the
expected parameter tree without allocating it).

Layouts: conv kernels OIHW ``(cout, cin // groups, kh, kw)``; linear kernels
``(cin, cout)`` applied as ``x @ w``, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class Init:
    """Where and how parameters are drawn: generator, device and dtype."""
    generator: torch.Generator | None
    device: torch.device
    dtype: torch.dtype = torch.float32

    def uniform(self, shape, bound: float) -> torch.Tensor:
        t = torch.empty(shape, device=self.device, dtype=self.dtype)
        if t.device.type != "meta":
            t.uniform_(-bound, bound, generator=self.generator)
        return t

    def normal(self, shape, std: float) -> torch.Tensor:
        t = torch.empty(shape, device=self.device, dtype=self.dtype)
        if t.device.type != "meta":
            t.normal_(0.0, std, generator=self.generator)
        return t

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, device=self.device, dtype=self.dtype)

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(shape, device=self.device, dtype=self.dtype)

    def full(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, value, device=self.device, dtype=self.dtype)


def make_init(generator=None, device=None, dtype=torch.float32, seed: int = 0) -> Init:
    """An ``Init`` on ``device``; without a generator, one seeded with ``seed``."""
    device = torch.device(device)
    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device).manual_seed(seed)
    return Init(generator, device, dtype)


def kaiming_uniform(ini: Init, shape, fan_in: int, a: float = math.sqrt(5.0)):
    """torch.nn.init.kaiming_uniform_ with leaky-relu gain (JAX ``kaiming_uniform``)."""
    gain = math.sqrt(2.0 / (1.0 + a * a))
    return ini.uniform(shape, gain * math.sqrt(3.0 / fan_in))


def conv_kernel(ini: Init, kh, kw, cin, cout, groups: int = 1):
    """OIHW conv kernel; same fan-in and bound as JAX ``conv_kernel`` (HWIO)."""
    return kaiming_uniform(ini, (cout, cin // groups, kh, kw), kh * kw * (cin // groups))


def conv_bias(ini: Init, cout: int, fan_in: int):
    return ini.uniform((cout,), 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0)


def linear_kernel(ini: Init, cin, cout):
    return kaiming_uniform(ini, (cin, cout), cin)
