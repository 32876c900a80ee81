"""``idle_pct.grad2d`` of ``marmousi-iso-grad``: the share of its traced
2-D objective-and-gradient units' wall time with no device operation, in %."""
from h100_bench.readers import idle_pct as read  # noqa: F401
