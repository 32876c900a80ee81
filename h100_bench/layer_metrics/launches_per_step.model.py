"""``launches_per_step.model`` of ``overthrust-iso-model``: device operations per
shot-step of its traced forward-modelling units."""
from h100_bench.readers import launches_per_step as read  # noqa: F401
