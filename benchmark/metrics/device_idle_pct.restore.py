"""Device idle share of the traced restore window (`torch.profiler`)."""

from benchmark.metrics._read import idle_pct as read  # noqa: F401
