"""Seeds of a run's independent draws, derived from ``--seed``."""

from __future__ import annotations

import hashlib

import numpy as np


def derive(seed: int, label: str) -> int:
    """A 63-bit seed for the draw named ``label`` (weights, images, noise, ...)
    of run seed ``seed``, any whole number >= 0."""
    key = int.from_bytes(hashlib.sha256(label.encode()).digest()[:4], "little")
    state = np.random.SeedSequence(int(seed), spawn_key=(key,)).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])
