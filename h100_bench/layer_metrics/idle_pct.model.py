"""``idle_pct.model`` of ``overthrust-iso-model``: the share of its traced
forward-modelling units' wall time with no device operation, in %."""
from h100_bench.readers import idle_pct as read  # noqa: F401
