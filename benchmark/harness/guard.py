"""The run's import guard: no JAX and no JAX package in the process.

Module names are compared by their top-level name (the part before the first
dot), whole: ``unirestore_torch`` is not ``unirestore_tpu``.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "unirestore_tpu")


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default ``sys.modules``)."""
    names = {name.split(".", 1)[0] for name in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))
