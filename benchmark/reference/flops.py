"""Tensor-core work of a call, counted on ``meta`` through the reference model.

Convolutions, matrix products and attention's two products, as
``torch.utils.flop_counter`` counts them: the work an MFU is a share of,
whatever implements it. Nothing is allocated or run.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode


def count(fn) -> int:
    """FLOPs of ``fn()``, which reads ``meta`` tensors, under inference mode."""
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()
