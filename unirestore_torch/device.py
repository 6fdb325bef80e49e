"""Device choice shared by the port's entry points.

Entry points run on the card unless the caller names another device: with no
CUDA device and no explicit ``device`` they raise instead of carrying on on
the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device; anything else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
