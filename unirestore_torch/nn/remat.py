"""Per-unit rematerialisation (the port's ``jax.checkpoint``).

``checkpoint(fn, *args)`` runs ``fn`` keeping none of its intermediates for
the backward pass; the backward recomputes them by running ``fn`` again
(``torch.utils.checkpoint`` without reentrancy). The recompute runs with
``recomputing()`` true in its thread, so the kernel wrappers can count their
launches there apart from the first forward. Without grad, ``fn`` runs once.
"""

from __future__ import annotations

import threading

import torch.utils.checkpoint as _ckpt

_state = threading.local()


def recomputing() -> bool:
    """True while a checkpointed unit recomputes its forward in the backward pass."""
    return getattr(_state, "depth", 0) > 0


def checkpoint(fn, *args):
    """``fn(*args)``, rematerialised in the backward pass."""
    calls = 0

    def run(*a):
        nonlocal calls
        calls += 1
        if calls == 1:
            return fn(*a)
        _state.depth = getattr(_state, "depth", 0) + 1
        try:
            return fn(*a)
        finally:
            _state.depth -= 1

    # the units are deterministic: no RNG state to stash and restore
    return _ckpt.checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)
