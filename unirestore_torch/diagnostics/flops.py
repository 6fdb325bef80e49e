"""FLOPs of a call (the port of ``tools/profile_components.py:flops_of``, :62-70).

The JAX tool asks XLA's cost analysis of the compiled call, which counts
every operation, elementwise work included. The port counts with
``torch.utils.flop_counter.FlopCounterMode`` instead, and that counts
tensor-core work only: convolutions, matrix products and attention. The
port's numbers are therefore the work an MFU is a share of, and lower than
XLA's for the same call by the elementwise work (norms, activations, the
scheduler's arithmetic).

``count(fn)`` runs ``fn`` on ``meta`` tensors, so nothing is
allocated and nothing runs on a device: a full-width restore is counted on
any machine. On ``meta`` the repo's kernels cannot launch, so inside
``plain_kernels()`` every kernel wrapper given ``meta`` tensors computes its
plain PyTorch version, whose products the counter sees, and refuses any
other tensor; their counts are the kernels' closed forms
(``attention_flops``, ``grouped_conv_flops``; the tests pin both). Either way
the count is the work of the call, whatever implements it.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..nn import kernels as KN


def _meta_plain(kern):
    """``kern``'s plain version on ``meta`` tensors; any other tensor raises,
    so that no call on a device leaves the kernel for its plain version."""
    def forward(*args):
        devices = {a.device.type for a in args if isinstance(a, torch.Tensor)}
        if devices != {"meta"}:
            raise ValueError(f"{kern.symbol}: plain_kernels() counts on meta tensors only, "
                             f"got {sorted(devices)}")
        return kern.plain(*args)
    return forward


@contextlib.contextmanager
def plain_kernels():
    """Within the block every kernel wrapper of ``nn/kernels.py`` computes its
    plain version on ``meta`` tensors, counts no launch, and raises on a
    tensor anywhere else."""
    for kern in KN.KERNELS:
        kern.forward = _meta_plain(kern)  # the instance attribute hides the method
    try:
        yield
    finally:
        for kern in KN.KERNELS:
            del kern.forward


def count(fn) -> int:
    """FLOPs of ``fn()``, which reads ``meta`` tensors, its kernels through
    their plain versions (``plain_kernels``): counted without computing."""
    with plain_kernels(), torch.inference_mode(), FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def attention_flops(batch: int, heads: int, t: int, s: int, d: int) -> int:
    """softmax(q kᵀ) v over ``heads`` heads of width ``d``: two products of
    2 t s d each per head."""
    return 4 * batch * heads * t * s * d


def grouped_conv_flops(batch: int, h: int, w: int, c: int, groups: int = 16) -> int:
    """A 3x3 convolution of ``c`` channels in ``groups`` groups, SAME padding."""
    return 2 * batch * h * w * 9 * c * c // groups
