"""``idle_pct.grad`` of ``overthrust-iso-grad``: the share of its traced
3-D objective-and-gradient units' wall time with no device operation, in %."""
from h100_bench.readers import idle_pct as read  # noqa: F401
