"""A restore's tensor-core work over its window at the bf16 peak."""

from benchmark.metrics._read import mfu as read  # noqa: F401
