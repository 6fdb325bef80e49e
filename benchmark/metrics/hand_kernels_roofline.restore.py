"""The five hand kernels' share of their roofline in a restore."""

from benchmark.metrics._read import hand_kernels_roofline as read  # noqa: F401
