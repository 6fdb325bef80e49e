"""Device ms per image of elementwise work and norm statistics in a restore."""

from benchmark.metrics._read import norm_elementwise_ms_per_img as read  # noqa: F401
